"""The assigned input-shape set.  Every LM arch is paired with all four;
decode/long shapes lower ``serve_step`` (one token against a seq_len
cache), not ``train_step``; long_500k applies only to sub-quadratic
archs (DESIGN.md §4)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg) -> list[str]:
    """Shape cells that apply to an arch (skips documented in DESIGN.md)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.pure_full_attention:
        out.append("long_500k")
    return out
