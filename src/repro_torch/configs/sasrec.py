"""SASRec [arXiv:1808.09781]: embed_dim 50, 2 blocks, 1 head, seq_len 50;
the item table is the huge sparse embedding of the recsys regime (2^20
rows).  The port's own copy of ``repro.configs.sasrec``;
``input_specs`` gives a shape's batch as ``device="meta"`` tensors (JAX's
gives shape structs)."""
import torch

from repro_torch.models.recsys.sasrec import SASRecConfig

FAMILY = "recsys"
SKIP_SHAPES = {}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train", "batch": 65_536},
    "serve_p99":      {"kind": "serve", "batch": 512},
    "serve_bulk":     {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}


def full_config() -> SASRecConfig:
    # 1,048,575 items + the padding row: a 2^20-row table
    return SASRecConfig(name="sasrec", n_items=1_048_575, embed_dim=50,
                        n_blocks=2, n_heads=1, seq_len=50)


def smoke_config() -> SASRecConfig:
    return SASRecConfig(name="sasrec-smoke", n_items=500, embed_dim=16,
                        n_blocks=2, n_heads=1, seq_len=10)


def input_specs(shape_name: str, cfg: SASRecConfig):
    """The batch of ``shape_name`` as int32 ``device="meta"`` tensors."""
    info = RECSYS_SHAPES[shape_name]
    B, S = info["batch"], cfg.seq_len

    def ids(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if info["kind"] == "train":
        return {"seq": ids(B, S), "pos": ids(B, S), "neg": ids(B, S)}
    if info["kind"] == "retrieval":
        return {"seq": ids(B, S), "candidates": ids(B, info["n_candidates"])}
    return {"seq": ids(B, S)}
