"""NequIP, an O(3)-equivariant interatomic potential (arXiv:2101.03164):
the port of ``repro.models.gnn.nequip``.

Config: n_layers=5, d_hidden=32 (channels per irrep), l_max=2, n_rbf=8,
cutoff=5 Å, E(3)-tensor-product interactions.

Irrep features are stored per degree l as ``[V, C, 2l+1]`` tensors (real
spherical-harmonic basis). The interaction block is the NequIP
convolution

    m_j->i = Σ_paths  R_path(r_ij) ⊗ ( h_j^{l1} ⊗ Y^{l2}(r̂_ij) )_{l3}

where the ``l1 × l2 → l3`` couplings are contracted with numerically
computed Gaunt coefficients ``G[l1,l2,l3][m1,m2,m3] = ∫ Y_{l1m1}
Y_{l2m2} Y_{l3m3} dΩ``, evaluated exactly by Gauss–Legendre (θ) ×
trapezoid (φ) quadrature in numpy: the same code as the reference's,
so the float32 tables are bit-equal. Gaunt coefficients differ from
Clebsch–Gordan only by per-(l1,l2,l3) scalars, which the learnable
radial weights absorb.

Selection rules keep 11 parity-even paths at l_max=2. The radial network
is an MLP over a Bessel basis with the DimeNet polynomial cutoff
envelope. The nonlinearity is the NequIP gate: SiLU on scalars,
sigmoid(scalar gates) multiplying l>0 irreps. Energy is an invariant
(l=0) readout summed per graph; forces are exact ``-∂E/∂positions``
(autograd).

Message passing is edge gather -> segment sum: each path's message
``[chunk, C, 2l3+1]`` is summed into the nodes as ``[chunk,
C·(2l3+1)]`` rows on the segment-reduce kernel (``common.scatter_sum``),
and so is the per-graph energy. Edges go in chunks of ``edge_chunk``
(the last padded with masked edges), each chunk under ``checkpoint``
when ``cfg.remat``, and each layer too, as the reference's nested
``jax.checkpoint(nothing_saveable)`` scans do.

With ``cfg.dist_axes`` set, the model runs the reference's ``shard_map``
mode over a mesh's slots, all from this one process (as the multi-shard
CC engine does): ``params`` and ``batch`` become lists, one entry a slot
in ``mesh.slot_devices(cfg.dist_axes)`` order, the batches cut by
``shard_batch`` (node arrays in k contiguous blocks, edges in k
contiguous blocks that carry global node ids). The positions are
all-gathered once; each layer all-gathers the features once, sums each
slot's edge chunks into all |V| rows, and reduce-scatters the partials
back to node shards (``launch.collectives``); the energy partials are
summed. The plain mode is this path on one slot: the same ops, no
collective.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import collectives
from repro_torch.models.gnn import common as C
from repro_torch.models.layers import normal_init


# ==========================================================================
# Real spherical harmonics (orthonormal, Condon–Shortley-free real basis)
# ==========================================================================

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2A, _C2B, _C2C = 1.0925484305920792, 0.31539156525252005, \
    0.5462742152960396


def _sh_np(xyz: np.ndarray, l_max: int) -> list[np.ndarray]:
    """Real SH on unit vectors, numpy (used for quadrature tables)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = [np.full(x.shape + (1,), _C0)]
    if l_max >= 1:
        out.append(np.stack([_C1 * y, _C1 * z, _C1 * x], axis=-1))
    if l_max >= 2:
        out.append(np.stack([
            _C2A * x * y, _C2A * y * z, _C2B * (3 * z * z - 1),
            _C2A * x * z, _C2C * (x * x - y * y)], axis=-1))
    return out[: l_max + 1]


def spherical_harmonics(unit: torch.Tensor, l_max: int) -> list:
    """Real SH of unit vectors ``[E, 3]`` -> list of ``[E, 2l+1]``."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    out = [torch.full(x.shape + (1,), _C0, dtype=unit.dtype,
                      device=unit.device)]
    if l_max >= 1:
        out.append(torch.stack([_C1 * y, _C1 * z, _C1 * x], dim=-1))
    if l_max >= 2:
        out.append(torch.stack([
            _C2A * x * y, _C2A * y * z, _C2B * (3 * z * z - 1),
            _C2A * x * z, _C2C * (x * x - y * y)], dim=-1))
    return out[: l_max + 1]


@functools.lru_cache(maxsize=None)
def _gaunt_np(l_max: int) -> dict:
    """Exact Gaunt tensors {(l1,l2,l3): float64 [2l1+1, 2l2+1, 2l3+1]}
    for all parity-even paths with l* <= l_max.

    Quadrature: Gauss–Legendre in u=cosθ (degree ≤ 3·l_max polynomial →
    n_u = 2·l_max+2 nodes exact) × uniform trapezoid in φ (trig degree ≤
    3·l_max → n_φ = 4·l_max+4 exact).
    """
    n_u = 2 * l_max + 2
    n_phi = 6 * l_max + 4
    u, wu = np.polynomial.legendre.leggauss(n_u)
    phi = 2 * np.pi * np.arange(n_phi) / n_phi
    w_phi = 2 * np.pi / n_phi
    uu, pp = np.meshgrid(u, phi, indexing="ij")          # [n_u, n_phi]
    st = np.sqrt(1 - uu * uu)
    xyz = np.stack([st * np.cos(pp), st * np.sin(pp), uu], axis=-1)
    sh = _sh_np(xyz.reshape(-1, 3), l_max)               # list [N, 2l+1]
    w = (wu[:, None] * w_phi * np.ones_like(pp)).reshape(-1)

    tables = {}
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if not (abs(l1 - l2) <= l3 <= l1 + l2):
                    continue
                if (l1 + l2 + l3) % 2 != 0:
                    continue  # parity-odd Gaunt integrals vanish
                g = np.einsum("n,na,nb,nc->abc",
                              w, sh[l1], sh[l2], sh[l3])
                g[np.abs(g) < 1e-12] = 0.0
                if np.abs(g).max() > 1e-10:
                    tables[(l1, l2, l3)] = g
    return tables


@functools.lru_cache(maxsize=None)
def gaunt_tables(l_max: int, device=None) -> dict:
    """The Gaunt tensors as float32 tensors on ``device`` (the CPU when
    None), rounded once from the float64 quadrature, as the reference's
    ``jnp.asarray(g, jnp.float32)``; made once a device."""
    return {k: torch.from_numpy(g.astype(np.float32)).to(device)
            for k, g in _gaunt_np(l_max).items()}


def coupling_paths(l_max: int) -> list[tuple[int, int, int]]:
    return sorted(_gaunt_np(l_max).keys())


# ==========================================================================
# Radial basis
# ==========================================================================

def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float
                 ) -> torch.Tensor:
    """sqrt(2/c)·sin(nπr/c)/r (n = 1..n_rbf), DimeNet polynomial envelope
    (p=6). r: [E] -> [E, n_rbf]; r=0 (padding self-loops) is safe."""
    r_safe = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n[None, :] * math.pi * r_safe[:, None] / cutoff) / r_safe[:, None]
    # polynomial cutoff envelope: 1 at r=0, C^2-smooth 0 at r=cutoff
    p = 6.0
    d = torch.clamp(r / cutoff, 0.0, 1.0)
    env = (1.0 - (p + 1) * (p + 2) / 2 * d ** p
           + p * (p + 2) * d ** (p + 1)
           - p * (p + 1) / 2 * d ** (p + 2))
    return basis * env[:, None] * (r > 0).to(r.dtype)[:, None]


# ==========================================================================
# Config / parameters
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep degree
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    radial_hidden: int = 64
    remat: bool = True          # edge-chunk remat: [E, C, m] path
                                # messages are recomputed in backward,
                                # never stored
    edge_chunk: int = 1 << 18   # edges per message chunk (a slot's)
    dist_axes: tuple = ()       # mesh-slot mode: node/edge arrays are
                                # per-slot; each layer all-gathers feats
                                # and reduce-scatters messages over the
                                # slots of these mesh axes
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: NequIPConfig) -> dict:
    L, c, n_l = cfg.n_layers, cfg.d_hidden, cfg.l_max + 1
    out = {"embed": (cfg.n_species, c),
           "layers.radial.w1": (L, cfg.n_rbf, cfg.radial_hidden),
           "layers.radial.b1": (L, cfg.radial_hidden),
           "layers.radial.w2": (L, cfg.radial_hidden,
                                len(coupling_paths(cfg.l_max)) * c)}
    for l in range(n_l):
        out[f"layers.self.{l}"] = (L, c, c)
    out["layers.gate_w"] = (L, c, (n_l - 1) * c)
    out["layers.gate_b"] = (L, (n_l - 1) * c)
    out.update({"head.w1": (c, c), "head.b1": (c,), "head.w2": (c, 1)})
    return out


def init(cfg: NequIPConfig, *, generator: torch.Generator | None = None,
         device=None, requires_grad: bool = False) -> dict:
    """Random parameters with the reference's scales, the layers' leaves
    stacked [L, ...]: the species embedding N(0, 1), weights N(0,
    1/fan_in), biases 0, the head's last weight 1e-2."""
    g, dev = C.generator_and_device(generator, device)
    n_paths = len(coupling_paths(cfg.l_max))
    n_l, c, dt = cfg.l_max + 1, cfg.d_hidden, cfg.dtype

    def normal(shape, std):
        return normal_init(shape, std, dt, **g)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    layers = [{
        "radial": {"w1": normal((cfg.n_rbf, cfg.radial_hidden),
                                cfg.n_rbf ** -0.5),
                   "b1": zeros(cfg.radial_hidden),
                   "w2": normal((cfg.radial_hidden, n_paths * c),
                                cfg.radial_hidden ** -0.5)},
        "self": [normal((c, c), c ** -0.5) for _ in range(n_l)],
        "gate_w": normal((c, (n_l - 1) * c), c ** -0.5),
        "gate_b": zeros((n_l - 1) * c),
    } for _ in range(cfg.n_layers)]

    def stack(*leaves):
        return torch.stack(leaves)
    stacked = {
        "radial": {k: stack(*(lp["radial"][k] for lp in layers))
                   for k in ("w1", "b1", "w2")},
        "self": [stack(*(lp["self"][l] for lp in layers))
                 for l in range(n_l)],
        "gate_w": stack(*(lp["gate_w"] for lp in layers)),
        "gate_b": stack(*(lp["gate_b"] for lp in layers)),
    }
    return C.trainable({
        "embed": normal((cfg.n_species, c), 1.0),
        "layers": stacked,
        "head": {"w1": normal((c, c), c ** -0.5), "b1": zeros(c),
                 "w2": zeros(c, 1) + 1e-2},
    }, requires_grad)


def params_from_reference(tree: dict, cfg: NequIPConfig, *, device,
                          requires_grad: bool = False) -> dict:
    return C.params_from_reference(tree, param_shapes(cfg), cfg.dtype,
                                   device=device,
                                   requires_grad=requires_grad)


def state_from_reference(tree: dict, cfg: NequIPConfig, opt, *,
                         device) -> dict:
    return C.state_from_reference(
        params_from_reference(tree["params"], cfg, device=device,
                              requires_grad=True), tree, opt, device=device)


# ==========================================================================
# Sharding over a mesh's slots
# ==========================================================================

_EDGE_KEYS = ("src", "dst", "edge_mask")


def shard_batch(batch: dict, mesh, axes=("data",)) -> list[dict]:
    """``batch`` cut over the slots of ``mesh``'s ``axes``, as the
    reference's ``_build_gnn_shardmap`` specs it: the edge arrays
    (``src``, ``dst``, ``edge_mask``) in k contiguous blocks that keep
    their global node ids, every other array with as many rows as
    ``positions`` (positions, species, graph ids, node mask) in k
    contiguous blocks, the rest (the per-graph energies) whole on every
    slot. An ``edge_mask`` is cut with the edges (the reference's specs
    would replicate it, and its forward could not then apply it). Each
    slot's arrays go to its device; host arrays are taken as tensors. A
    row count that does not divide by k is refused, as ``shard_map``
    refuses it (``ValueError``)."""
    devices = mesh.slot_devices(axes)
    k = len(devices)
    n_nodes = batch["positions"].shape[0]
    out = [{} for _ in devices]
    for key, x in batch.items():
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        split = key in _EDGE_KEYS or (x.dim() and x.shape[0] == n_nodes)
        if split and x.shape[0] % k:
            raise ValueError(
                f"batch[{key!r}] of shape {tuple(x.shape)} maps axis 0 (of "
                f"size {x.shape[0]}) to mesh axes {tuple(axes)} (of size "
                f"{k}), but {k} does not evenly divide {x.shape[0]}")
        blocks = x.split(x.shape[0] // k) if split and k > 1 else [x] * k
        for slot, b, d in zip(out, blocks, devices):
            slot[key] = b.to(d)
    return out


# ==========================================================================
# Forward
# ==========================================================================

def _chunk_messages(lp: dict, cfg: NequIPConfig, tables: dict, feats: list,
                    num_nodes: int, s_, d_, em_, rb_, *ys) -> list:
    """One edge chunk's messages, summed into the nodes: a [V, C, 2l+1]
    tensor a degree l."""
    paths = coupling_paths(cfg.l_max)
    c, chunk = cfg.d_hidden, s_.shape[0]
    h = F.silu(rb_ @ lp["radial"]["w1"] + lp["radial"]["b1"])
    rw = (h @ lp["radial"]["w2"]).reshape(chunk, len(paths), c)
    rw = rw * em_[:, None, None]
    msgs = [None] * (cfg.l_max + 1)
    for pi, (l1, l2, l3) in enumerate(paths):
        x_src = feats[l1][s_]                                  # [ch, C, m1]
        # m[e,c,m3] = Σ_{m1,m2} x·y·g, modulated by the radial weight
        m = torch.einsum("eca,eb,abm->ecm", x_src, ys[l2], tables[
            (l1, l2, l3)])
        m = m * rw[:, pi, :, None]
        s = C.scatter_sum(m.reshape(chunk, -1), d_, num_nodes).reshape(
            num_nodes, c, 2 * l3 + 1)
        msgs[l3] = s if msgs[l3] is None else msgs[l3] + s
    return msgs


def _messages(lp: dict, cfg: NequIPConfig, feats: list, sh: list,
              rbf: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              edge_mask: torch.Tensor) -> list:
    """One slot's messages over its edges, summed into every row of
    ``feats`` (all |V| nodes): computed per edge chunk (under
    ``checkpoint`` when ``cfg.remat``), so the [E, C, m] per-path
    message tensors exist only chunk-locally, forward and backward."""
    n_l, c = cfg.l_max + 1, cfg.d_hidden
    v, e = feats[0].shape[0], src.shape[0]
    tables = gaunt_tables(cfg.l_max, src.device)
    tables = {k: t.to(feats[0].dtype) for k, t in tables.items()}
    chunk = min(cfg.edge_chunk, e)
    nchunk = -(-e // chunk)
    pad = nchunk * chunk - e

    def pad_e(x):
        if pad == 0:
            return x
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    src_p, dst_p, mask_p, rbf_p = (pad_e(t) for t in (src, dst, edge_mask,
                                                      rbf))
    sh_p = [pad_e(y) for y in sh]
    msgs = [torch.zeros((v, c, 2 * l + 1), dtype=feats[0].dtype,
                        device=feats[0].device) for l in range(n_l)]
    for k in range(nchunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        xs = (src_p[sl], dst_p[sl], mask_p[sl], rbf_p[sl],
              *(y[sl] for y in sh_p))
        if cfg.remat:
            part = checkpoint(_chunk_messages, lp, cfg, tables, feats, v, *xs,
                              use_reentrant=False)
        else:
            part = _chunk_messages(lp, cfg, tables, feats, v, *xs)
        msgs = [m + p for m, p in zip(msgs, part)]
    return msgs


def _update(lp: dict, cfg: NequIPConfig, feats: list, msgs: list) -> list:
    """Self-interaction (channel mix per degree) + residual, then the
    gate nonlinearity: SiLU on scalars, l>0 scaled by sigmoid(gates)."""
    n_l, c = cfg.l_max + 1, cfg.d_hidden
    v = feats[0].shape[0]
    out = [feats[l] + torch.einsum("vcm,cd->vdm", msgs[l], lp["self"][l])
           for l in range(n_l)]
    scalars = out[0][..., 0]                                  # [V, C]
    gates = torch.sigmoid(scalars @ lp["gate_w"] + lp["gate_b"])
    gates = gates.reshape(v, n_l - 1, c)
    gated = [F.silu(scalars)[..., None]]
    for l in range(1, n_l):
        gated.append(out[l] * gates[:, l - 1, :, None])
    return gated


def _layer(lps: list, cfg: NequIPConfig, geometry: list, feats: list
           ) -> list:
    """One NequIP convolution + self-interaction + gate on every slot:
    ``lps``, ``geometry`` (each slot's sh, rbf, src, dst, edge mask) and
    ``feats`` (each slot's node shard, a list by degree) one a slot. The
    full node features are gathered once; each slot's edge chunks sum
    into all |V| rows, and the partials reduce-scatter back to node
    shards (on one slot both are no-ops)."""
    n_l, k = cfg.l_max + 1, len(feats)
    full = [collectives.all_gather([f[l] for f in feats])
            for l in range(n_l)]
    partial = [_messages(lps[j], cfg, [full[l][j] for l in range(n_l)],
                         *geometry[j]) for j in range(k)]
    msgs = [collectives.psum_scatter([p[l] for p in partial])
            for l in range(n_l)]
    return [_update(lps[j], cfg, feats[j], [msgs[l][j] for l in range(n_l)])
            for j in range(k)]


def _forward_slots(params: list, batches: list, cfg: NequIPConfig
                   ) -> list:
    """Per-graph energies [G] on every slot: the psum of the slots'
    partial energies."""
    b0 = batches[0]
    num_graphs = b0["energy"].shape[0] if "energy" in b0 else \
        max(int(b["graph_ids"].max()) for b in batches) + 1
    pos = [b["positions"].to(cfg.dtype) for b in batches]
    # node arrays are per-slot; edges carry GLOBAL node ids
    pos_full = collectives.all_gather(pos)
    geometry, feats = [], []
    c = cfg.d_hidden
    for j, (p, b) in enumerate(zip(params, batches)):
        src, dst = b["src"], b["dst"]
        vec = pos_full[j][src] - pos_full[j][dst]             # [E, 3]
        r = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
        unit = vec / torch.clamp(r, min=1e-9)[:, None]
        edge_mask = ((r > 0) & (r < cfg.cutoff)).to(cfg.dtype)
        if "edge_mask" in b:
            edge_mask = edge_mask * b["edge_mask"].to(cfg.dtype)
        sh = spherical_harmonics(unit, cfg.l_max)
        rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)
        geometry.append((sh, rbf, src, dst, edge_mask))
        v = pos[j].shape[0]
        f = [p["embed"][b["species"].long()][..., None]]
        for l in range(1, cfg.l_max + 1):
            f.append(torch.zeros((v, c, 2 * l + 1), dtype=cfg.dtype,
                                 device=pos[j].device))
        feats.append(f)
    for i in range(cfg.n_layers):
        lps = [C.tree_map(lambda t: t[i], p["layers"]) for p in params]
        args = (lps, cfg, geometry, feats)
        feats = checkpoint(_layer, *args, use_reentrant=False) \
            if cfg.remat else _layer(*args)

    # invariant readout: per-atom energy -> per-graph sum, each slot's
    # partial over its node shard
    partial = []
    for p, b, f in zip(params, batches, feats):
        s = f[0][..., 0]
        e_atom = (F.silu(s @ p["head"]["w1"] + p["head"]["b1"])
                  @ p["head"]["w2"])[:, 0]
        if "node_mask" in b:
            e_atom = e_atom * b["node_mask"].to(e_atom.dtype)
        partial.append(C.scatter_sum(e_atom, b["graph_ids"], num_graphs))
    return collectives.psum(partial)


def _slots(params, batch, cfg: NequIPConfig) -> tuple:
    """(params, batches) one a slot: the plain mode is one slot; with
    ``dist_axes`` the batches are a list and ``params`` a list of
    per-slot trees, or one tree every slot reads."""
    if not cfg.dist_axes:
        return [params], [batch]
    batches = list(batch)
    if isinstance(params, dict):
        return [params] * len(batches), batches
    return list(params), batches


def forward(params: dict, batch: dict, cfg: NequIPConfig):
    """batch: positions [V,3], species [V], src/dst [E], graph_ids [V],
    energy [G] (its length is the graph count; without it, the largest
    graph id + 1). Returns per-graph energies [G]. With
    ``cfg.dist_axes``: ``batch`` a list of slot batches
    (``shard_batch``), ``params`` one tree or one a slot; returns the
    energies on every slot, a list."""
    out = _forward_slots(*_slots(params, batch, cfg), cfg)
    return out if cfg.dist_axes else out[0]


def forces(params: dict, batch: dict, cfg: NequIPConfig):
    """Exact conservative forces F = -∂E_total/∂positions; with
    ``cfg.dist_axes``, each slot's node shard of them, a list. Every slot
    holds the summed energies, so E_total is read from slot 0's copy:
    each position's gradient is counted once."""
    ps, bs = _slots(params, batch, cfg)
    pos = [b["positions"].to(cfg.dtype).detach().requires_grad_(True)
           for b in bs]
    with torch.enable_grad():
        energy = _forward_slots(ps, [{**b, "positions": p}
                                     for b, p in zip(bs, pos)], cfg)
        grads = torch.autograd.grad(energy[0].sum(), pos)
    out = [-g for g in grads]
    return out if cfg.dist_axes else out[0]


def loss_fn(params: dict, batch: dict, cfg: NequIPConfig):
    """Energy MSE (per graph); with ``cfg.dist_axes``, every slot's
    (equal) loss, a list."""
    ps, bs = _slots(params, batch, cfg)
    out = []
    for pred, b in zip(_forward_slots(ps, bs, cfg), bs):
        err = pred - b["energy"].to(pred.dtype)
        out.append(torch.mean(err * err))
    return out if cfg.dist_axes else out[0]
