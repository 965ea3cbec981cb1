"""Whole AdamW train steps of ``build_cell(arch, "train_4k")`` against
the reference's, on the CPU, for qwen2.5-32b; the gates are in
``tests/_lm_train_common.py``."""
import pytest

from _lm_train_common import train_steps_match_reference


@pytest.mark.parametrize("arch", ("qwen2.5-32b",))
def test_train_steps_match_reference(arch, monkeypatch):
    train_steps_match_reference(arch, monkeypatch)
