"""``launch.train`` on nequip, on the CPU: 30 steps with a failure at 15
and one restart from the checkpoint at 10."""
import re

import pytest

from repro_torch.launch import train as launch_train

from _threads import one_thread  # noqa: F401  (the launcher's small ops)


@pytest.mark.parametrize("arch", ("nequip",))
def test_launcher_trains_every_gnn_and_recovers(arch, tmp_path, capsys):
    """``launch.train --arch <gnn> --steps 30 --fail-at 15 --device
    cpu``: returns 0 after one restart (from the checkpoint at 10), and
    the loss falls."""
    rc = launch_train.main(["--arch", arch, "--steps", "30", "--fail-at",
                            "15", "--ckpt-every", "10", "--device", "cpu",
                            "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    m = re.search(rf"\[train\] {re.escape(arch)} on cpu: 35 steps, 1 "
                  r"restarts, loss ([\d.]+) -> ([\d.]+)", out)
    assert m, out
    assert float(m.group(2)) < float(m.group(1))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[-1] == \
        "step_00000030"
