"""ISL expression vocabulary: the 167 INCLUDE-dataset sign classes.

Class ids are contiguous 0..166; the id->name table matches the reference
(src/expression_mapping.py:1-168) so translator outputs are interchangeable.
This is dataset metadata, not code.
"""

_NAMES = [
    "Adult", "Afternoon", "Alright", "Attack", "Bag", "Ball", "Bank",
    "Bathroom", "Beautiful", "Bed", "Bedroom", "Bill", "Blind", "Book",
    "Box", "Card", "Chair", "Child", "City", "Court", "Crowd", "Deaf",
    "Death", "Door", "Dream", "Election", "Energy", "Evening", "Ex. Monsoon",
    "Exercise", "Fall", "Friend", "Gift", "God", "Ground", "Gun", "Hello",
    "Hospital", "Hour", "House", "How are you", "I", "India", "Key",
    "Kitchen", "Letter", "Library", "Location", "Lock", "Market", "Marriage",
    "Mean", "Medicine", "Minute", "Money", "Month", "Morning", "Newspaper",
    "Nice", "Night", "Office", "Page", "Paint", "Paper", "Park", "Peace",
    "Pen", "Pencil", "Photograph", "Player", "Pleased", "Price", "Queen",
    "Race (ethnicity)", "Religion", "Restaurant", "Ring", "School",
    "Science", "Season", "Second", "Sign", "Soap", "Sport", "Spring",
    "Store or Shop", "Street or Road", "Summer", "Sunday", "Table", "Team",
    "Technology", "Telephone", "Temple", "Time", "Today", "Tomorrow", "Tool",
    "Train Station", "Ugly", "University", "War", "Week", "Window", "Winter",
    "Year", "Yesterday", "alive", "bad", "big large", "cheap", "clean",
    "cold", "cool", "curved", "dead", "deep", "dirty", "dry", "expensive",
    "famous", "fast", "female", "flat", "good", "happy", "hard", "he",
    "healthy", "heavy", "high", "hot", "it", "light", "long", "loose",
    "loud", "low", "male", "narrow", "new", "old", "poor", "quiet", "rich",
    "sad", "shallow", "she", "short", "sick", "slow", "small little", "soft",
    "strong", "tall", "they", "thick", "thin", "tight", "warm", "we", "weak",
    "wet", "wide", "you", "you (plural)", "young",
]

EXPRESSIONS = dict(enumerate(_NAMES))
