"""Model introspection: parameter tables and shape contracts (port of
islx/utils/summary.py).

Replaces the reference's torchinfo dumps (model_param.py:49-92,
ISL_model_params.py:18-41) and the hand-net output-size sweep
(src/hand_model_outputsize.py + src/hand_model_output_size.json: the LUT
the reference precomputed by running every input size 10..999 through the
net). The output size is a closed-form function of the conv geometry, so
the sweep is a formula here.

    python -m islx_torch.cli.summary body25|coco|hand
"""
from __future__ import annotations

from typing import Dict, List

from islx_torch.models import cpm


def output_size(input_px: int, n_pools: int = 3) -> int:
    """Spatial output size of the CPM trunks for a square input: 3x3
    convs with pad 1 keep the size, each 2x2/2 VALID max-pool floors /2."""
    n = input_px
    for _ in range(n_pools):
        n = n // 2
    return n


def hand_output_size_table(lo: int = 10, hi: int = 999) -> Dict[str, int]:
    """{input px: output px}: regenerates src/hand_model_output_size.json."""
    return {str(i): output_size(i) for i in range(lo, hi + 1)}


def summarize(model_type: str) -> str:
    """Per-layer parameter table (torchinfo-style)."""
    lines: List[str] = []
    lines.append(f"model: {model_type}")
    lines.append(f"{'layer':<28}{'kernel':<18}{'act':<8}{'params':>12}")
    lines.append("-" * 66)
    total = 0
    for c in cpm.conv_layers(model_type):
        n = cpm.conv_params(c)
        total += n
        kernel = f"{c.k}x{c.k}x{c.cin}->{c.cout}"
        lines.append(f"{c.name:<28}{kernel:<18}{c.act:<8}{n:>12,}")
    lines.append("-" * 66)
    lines.append(f"{'total':<54}{total:>12,}")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_type", choices=["body25", "coco", "hand"])
    args = p.parse_args(argv)
    print(summarize(args.model_type))


if __name__ == "__main__":
    main()
