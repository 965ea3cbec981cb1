"""Whole AdamW train steps of ``build_cell(arch, "train_4k")`` against
the reference's, on the CPU, for gemma2-2b, minicpm3-4b and phi3.5-moe;
the gates are in ``tests/_lm_train_common.py``."""
import pytest

from _lm_train_common import train_steps_match_reference


@pytest.mark.parametrize("arch", ("gemma2-2b", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b"))
def test_train_steps_match_reference(arch, monkeypatch):
    train_steps_match_reference(arch, monkeypatch)
