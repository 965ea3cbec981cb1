"""dcn-v2 [recsys]: 13 dense, 26 sparse, embed_dim=16, 3 cross layers,
MLP 1024-1024-512, cross interaction. [arXiv:2008.13535; paper]

Shapes: train_batch B=65,536 (train) · serve_p99 B=512 (online) ·
serve_bulk B=262,144 (offline scoring) · retrieval_cand 1×1,000,000
(single query against 1M candidates — one batched product)."""
from __future__ import annotations

import torch

from repro_torch.models.recsys import CRITEO_TABLE_SIZES, RecsysConfig

ARCH_ID = "dcn-v2"
FAMILY = "recsys"
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

SHAPE_DEFS = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           candidates=1_000_000),
}


def make_config() -> RecsysConfig:
    return RecsysConfig(name=ARCH_ID, n_dense=13, n_sparse=26,
                        embed_dim=16, n_cross=3, mlp=(1024, 1024, 512),
                        table_sizes=CRITEO_TABLE_SIZES,
                        dtype=torch.bfloat16)


def make_smoke_config() -> RecsysConfig:
    return RecsysConfig(name=ARCH_ID + "-smoke", n_dense=5, n_sparse=4,
                        embed_dim=8, n_cross=2, mlp=(64, 32, 16),
                        table_sizes=(100, 50, 80, 30))


def step_kind(shape: str) -> str:
    return SHAPE_DEFS[shape]["kind"]


def skip_reason(shape: str):
    return None


def input_specs(shape: str) -> dict:
    """``{"batch": {name: (shape, dtype)}}`` (plus ``candidate_ids``
    for retrieval): what the step takes, allocated nowhere."""
    cfg = make_config()
    d = SHAPE_DEFS[shape]
    b = d["batch"]
    batch = {
        "dense": ((b, cfg.n_dense), torch.float32),
        "sparse_idx": ((b, cfg.n_sparse), torch.int32),
        "label": ((b,), torch.int32),
    }
    if d["kind"] == "retrieval":
        return {"batch": batch,
                "candidate_ids": ((d["candidates"],), torch.int32)}
    return {"batch": batch}
