"""DCN-v2 (arXiv:2008.13535) — deep & cross network for CTR / ranking,
the port of ``repro.models.recsys``.

Assigned config: 13 dense features, 26 sparse features, embed_dim=16,
3 cross layers, MLP tower 1024-1024-512, cross interaction.

The sparse hot path is the embedding lookup over ONE fused table (all
26 feature tables stacked row-wise; per-feature row offsets are added
to the indices). Two hand-written kernels carry it:

  * ``fused_lookup`` — the ``embedding_bag`` kernel: a one-hot
    [B, F] batch is B·F bags of 1 (a bit-exact gather), a multi-hot
    [B, F, H] batch B·F bags of H;
  * ``embedding_bag`` (general ragged bags) — a gather, then the
    ``segment_reduce`` kernel sums the rows of each bag (and, for
    ``mean``, counts them).

Cross network (DCN-v2, full-rank W), in parallel with the deep tower:
    x_{l+1} = x_0 ⊙ (x_l W_l + b_l) + x_l
and their concatenation feeds the logit. The cross, MLP and head
products are plain ``torch.matmul``, as the reference leaves them to XLA.

Training: the parameters require grad when the model is built with
``requires_grad=True`` (serving builds them without). Both kernels then
run under ``kernels.autograd``'s Functions: the gradient of a lookup to the
table is the segment sum of its output-gradient rows by row id, on the
segment-reduce kernel's sorted body; the gradient of a segment sum to
its rows a gather, on the embedding-bag kernel.

Rounding: every op rounds to the config dtype as the reference's ops
do. Two places differ in bfloat16, each by its sums' rounding: a
multi-hot ``fused_lookup`` sums a bag in fp32 and rounds once (the
kernel), where the reference's model rounds each of its H - 1 partial
sums through a bfloat16 ``segment_sum``, so the two differ by at most
(H/2) bfloat16 ulps of the bag's magnitude sum|row|; and the table's
gradient sums the c lookups of a row in fp32 and rounds once, where the
reference's scatter-add rounds each of its c - 1 adds, at most (c/2)
ulps of sum|g| apart. In float32 the lookups agree exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.graphs.device import resolve_device
from repro_torch.kernels.autograd import \
    embedding_bag as embedding_bag_kernel, segment_reduce
from repro_torch.models import layers as L

# Criteo-like per-feature table sizes (hashed); padded to multiples of
# 16 the 26 tables hold 19,297,856 rows (617.5 MB at dim 16 in bf16).
CRITEO_TABLE_SIZES = (
    4_000_000, 25_000, 15_000, 7_000, 19_000, 4, 7_000, 1_500, 60,
    3_500_000, 500_000, 200_000, 11, 2_000, 10_000, 60, 4, 1_000, 15,
    4_000_000, 2_500_000, 4_000_000, 500_000, 10_000, 80, 30,
)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross: int = 3
    mlp: tuple = (1024, 1024, 512)
    table_sizes: tuple = CRITEO_TABLE_SIZES
    hotness: int = 1            # indices per bag (multi-hot when > 1)
    dtype: torch.dtype = torch.float32

    @property
    def padded_table_sizes(self) -> tuple:
        """Per-feature rows padded to a multiple of 16 (the reference
        shards the fused table's rows 16 ways)."""
        return tuple(((s + 15) // 16) * 16 for s in self.table_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.padded_table_sizes))

    @property
    def row_offsets(self) -> np.ndarray:
        """Start row of each feature's slice in the fused table."""
        sizes = self.padded_table_sizes
        return np.concatenate(
            [[0], np.cumsum(sizes[:-1])]).astype(np.int64)

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


# ==========================================================================
# EmbeddingBag
# ==========================================================================

def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int,
                  combine: str = "sum", *,
                  indices_are_sorted: bool = False) -> torch.Tensor:
    """General EmbeddingBag: rows = table[indices] (the embedding-bag
    kernel, bags of 1); the rows of each bag (int32 ``bag_ids``, in any
    order, as the reference's ``segment_sum`` over them takes them)
    reduce through the segment-reduce kernel. [nnz] -> [num_bags, dim];
    an empty bag is 0. ``indices_are_sorted`` promises ascending
    ``bag_ids`` and sends both segment sums to the kernel's sorted body;
    the default takes its atomic body."""
    rows = embedding_bag_kernel(table, indices.to(torch.int32)[:, None])
    out = segment_reduce(rows, bag_ids, num_bags, op="sum",
                         indices_are_sorted=indices_are_sorted)
    if combine == "mean":
        ones = torch.ones((indices.shape[0],), dtype=rows.dtype,
                          device=rows.device)
        cnt = segment_reduce(ones, bag_ids, num_bags, op="sum",
                             indices_are_sorted=indices_are_sorted)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def fused_lookup(table: torch.Tensor, sparse_idx: torch.Tensor,
                 row_offsets: torch.Tensor, combine: str = "sum"
                 ) -> torch.Tensor:
    """Fused-table lookup through the embedding-bag kernel. int32
    ``sparse_idx``: [B, F] (one-hot, bags of 1) or [B, F, H] (multi-hot,
    bags of H); returns [B, F, dim]. ``row_offsets`` (int32 [F]) are
    added first so all features read the one fused table."""
    b, f = sparse_idx.shape[:2]
    if sparse_idx.dim() == 2:
        flat = (sparse_idx + row_offsets[None, :]).reshape(b * f, 1)
    else:
        flat = (sparse_idx + row_offsets[None, :, None]).reshape(b * f, -1)
    return embedding_bag_kernel(table, flat, combine=combine).reshape(
        b, f, -1)


# ==========================================================================
# Parameters
# ==========================================================================

def param_shapes(cfg: RecsysConfig) -> dict:
    """``{name: shape}`` of every parameter, named as ``DCNv2`` names
    them (the reference's tree, flattened with dots)."""
    d = cfg.d_interact
    dims = [d, *cfg.mlp]
    shapes = {"table": (cfg.total_rows, cfg.embed_dim),
              "dense_norm.w": (cfg.n_dense,), "dense_norm.b": (cfg.n_dense,)}
    for i in range(cfg.n_cross):
        shapes[f"cross.{i}.w"] = (d, d)
        shapes[f"cross.{i}.b"] = (d,)
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"mlp.ws.{i}"] = (din, dout)
    for i, dout in enumerate(dims[1:]):
        shapes[f"mlp.bs.{i}"] = (dout,)
    shapes["head"] = (d + cfg.mlp[-1], 1)
    return shapes


def param_count(cfg: RecsysConfig) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(cfg).values())


class DCNv2(nn.Module):
    """The model's parameters as a module; ``model(batch)`` is
    ``forward(model, batch)``. Built by ``init`` (random, from a
    generator) or ``params_from_reference`` (carried values); the
    parameters require grad iff ``requires_grad``."""

    def __init__(self, cfg: RecsysConfig, params: dict,
                 requires_grad: bool = False):
        super().__init__()

        def param(t):
            return nn.Parameter(t, requires_grad=requires_grad)

        self.cfg = cfg
        self.table = param(params["table"])
        self.dense_norm = nn.ParameterDict(
            {k: param(v) for k, v in params["dense_norm"].items()})
        self.cross = nn.ModuleList(
            nn.ParameterDict({k: param(v) for k, v in cl.items()})
            for cl in params["cross"])
        self.mlp = nn.ModuleDict(
            {k: nn.ParameterList(param(v) for v in params["mlp"][k])
             for k in ("ws", "bs")})
        self.head = param(params["head"])
        self.register_buffer("row_offsets", torch.as_tensor(
            cfg.row_offsets, dtype=torch.int32, device=self.table.device))

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self, batch)


def init(cfg: RecsysConfig, *, generator: torch.Generator | None = None,
         device=None, requires_grad: bool = False) -> DCNv2:
    """Random DCN-v2 on ``device`` (CUDA unless given; raises without
    CUDA unless ``device="cpu"``), every draw from ``generator`` (a
    generator of that device seeded 0 when None); trainable iff
    ``requires_grad``."""
    dev = resolve_device(device)
    if generator is None:
        generator = L.seeded_generator(dev)
    g = {"generator": generator, "device": dev}
    d = cfg.d_interact
    zeros = lambda n: torch.zeros((n,), dtype=cfg.dtype, device=dev)
    return DCNv2(cfg, {
        "table": L.normal_init((cfg.total_rows, cfg.embed_dim),
                               cfg.embed_dim ** -0.5, cfg.dtype, **g),
        "dense_norm": {"w": torch.ones((cfg.n_dense,), dtype=cfg.dtype,
                                       device=dev),
                       "b": zeros(cfg.n_dense)},
        "cross": [{"w": L.normal_init((d, d), d ** -0.5, cfg.dtype, **g),
                   "b": zeros(d)} for _ in range(cfg.n_cross)],
        "mlp": L.mlp_params([d, *cfg.mlp], cfg.dtype, **g),
        "head": L.normal_init((d + cfg.mlp[-1], 1),
                              (d + cfg.mlp[-1]) ** -0.5, cfg.dtype, **g),
    }, requires_grad)


def params_from_reference(tree: dict, cfg: RecsysConfig, *,
                          device, requires_grad: bool = False) -> DCNv2:
    """A ``DCNv2`` holding exactly the values of the reference's
    parameter tree (``table``, ``dense_norm{w,b}``, ``cross[{w,b}]``,
    ``mlp{ws,bs}``, ``head``) given as host arrays; trainable iff
    ``requires_grad``. Raises if a shape or dtype differs from
    ``cfg``'s."""
    dev = resolve_device(device)

    def conv(a):
        return L.from_numpy(a).to(dev)

    model = DCNv2(cfg, {
        "table": conv(tree["table"]),
        "dense_norm": {k: conv(v) for k, v in tree["dense_norm"].items()},
        "cross": [{k: conv(v) for k, v in cl.items()}
                  for cl in tree["cross"]],
        "mlp": {k: [conv(v) for v in tree["mlp"][k]] for k in ("ws", "bs")},
        "head": conv(tree["head"]),
    }, requires_grad)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if got != param_shapes(cfg):
        raise ValueError(f"parameter shapes {got} do not match the config")
    for n, p in model.named_parameters():
        if p.dtype != cfg.dtype:
            raise ValueError(f"{n} is {p.dtype}, the config says "
                             f"{cfg.dtype}")
    return model


def state_from_reference(tree: dict, cfg: RecsysConfig, *,
                         device) -> dict:
    """A port TrainState (``train.train_state``) holding exactly the
    values of a reference TrainState given as host arrays: ``params``
    (a trainable ``DCNv2``), the optimizer's moment trees under ``opt``
    (keyed by parameter name) and ``step`` (int32)."""
    from repro_torch.train.optimizer import named

    dev = resolve_device(device)
    return {
        "params": params_from_reference(tree["params"], cfg, device=dev,
                                         requires_grad=True),
        "opt": {k: {n: L.from_numpy(v).to(dev)
                    for n, v in named(sub).items()}
                for k, sub in tree["opt"].items()},
        "step": torch.tensor(int(tree["step"]), dtype=torch.int32,
                             device=dev),
    }


# ==========================================================================
# Forward
# ==========================================================================

def interact(model: DCNv2, batch: dict) -> torch.Tensor:
    """dense [B, 13] + sparse_idx [B, 26(, H)] -> x0 [B, d_interact]."""
    cfg = model.cfg
    dense = batch["dense"].to(cfg.dtype)
    dense = dense * model.dense_norm["w"] + model.dense_norm["b"]
    emb = fused_lookup(model.table, batch["sparse_idx"], model.row_offsets)
    return torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1)


def cross_deep(model: DCNv2, x0: torch.Tensor) -> torch.Tensor:
    """The cross network and the deep tower on x0, concatenated:
    [B, d_interact + mlp[-1]]."""
    x = x0
    for cl in model.cross:
        x = x0 * (x @ cl["w"] + cl["b"]) + x
    deep = torch.relu(L.mlp_apply(model.mlp, x0))
    return torch.cat([x, deep], dim=-1)


def tower(model: DCNv2, x0: torch.Tensor) -> torch.Tensor:
    """Logits [B] from x0."""
    return (cross_deep(model, x0) @ model.head)[:, 0]


def forward(model: DCNv2, batch: dict) -> torch.Tensor:
    """Returns logits [B]."""
    return tower(model, interact(model, batch))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits on click labels, in float32
    (the numerically stable form)."""
    logits = logits.float()
    y = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def loss_fn(model: DCNv2, batch: dict) -> torch.Tensor:
    """Binary cross-entropy on click labels (float32)."""
    return bce_loss(forward(model, batch), batch["label"])


def project_scores(model: DCNv2, q: torch.Tensor,
                   cand: torch.Tensor) -> torch.Tensor:
    """Scores [N] (float32) of candidate rows ``cand`` [N, dim] against
    the query representation ``q`` [1, d_interact + mlp[-1]]: the query
    is projected into embedding space through the head."""
    ones = torch.ones((1, model.cfg.embed_dim), dtype=q.dtype,
                      device=q.device)
    q_proj = q @ model.head @ ones                       # [1, dim]
    return (cand @ q_proj[0]).float()


def retrieval_scores(model: DCNv2, batch: dict,
                     candidate_ids: torch.Tensor) -> torch.Tensor:
    """Score ONE query against N candidates: the query runs the full
    tower; each candidate contributes its row of the fused table
    (feature 0's slice), gathered by the embedding-bag kernel as bags
    of 1; the score is one batched product, float32 [N]."""
    q = cross_deep(model, interact(model, batch))        # [1, d + mlp]
    cand = embedding_bag_kernel(model.table, candidate_ids.reshape(-1, 1))
    return project_scores(model, q, cand)
