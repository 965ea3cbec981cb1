"""nequip [gnn]: 5 layers, d_hidden=32 channels, l_max=2, n_rbf=8,
cutoff=5, E(3)-tensor-product interactions. [arXiv:2101.03164; paper]

Non-molecular shapes are point clouds (synthetic coordinates): the
irrep tensor-product compute pattern is the same; see
``configs/gnn_common.nequip_specs``."""
from __future__ import annotations

from repro_torch.configs import gnn_common as GC
from repro_torch.models.gnn.nequip import NequIPConfig

ARCH_ID = "nequip"
FAMILY = "gnn"
SHAPES = GC.SHAPES


def make_config(shape: str = "molecule") -> NequIPConfig:
    return NequIPConfig(name=ARCH_ID, n_layers=5, d_hidden=32, l_max=2,
                        n_rbf=8, cutoff=5.0, n_species=32)


def make_smoke_config() -> NequIPConfig:
    return NequIPConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=8,
                        l_max=2, n_rbf=4, cutoff=5.0, n_species=4)


def step_kind(shape: str) -> str:
    return GC.step_kind(shape)


def skip_reason(shape: str):
    return None


def input_specs(shape: str) -> dict:
    return GC.nequip_specs(shape)
