"""Model summary CLI (port of islx/cli/summary.py; reference
model_param.py / ISL_model_params.py).

    python -m islx_torch.cli.summary body25|coco|hand
"""
from islx_torch.utils.summary import main

if __name__ == "__main__":
    main()
