"""The port's accuracy CLI (`python -m montecosmo_tpu_torch.accuracy`, run here
in-process with --device cpu) at 16^3 on the CPU: its four sections print
finite transfers and coherences; and the port's CLIs refuse to run without
a CUDA device unless --device cpu is given.  No JAX."""
import re

import numpy as np
import pytest
import torch

from montecosmo_tpu_torch import accuracy, register

torch.set_num_threads(1)


def test_accuracy_report_prints_four_finite_sections(capsys, monkeypatch):
    accuracy.main(["--final", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    heads = ["1. BullFrog(10) vs 2LPT:", "2. evol_oversamp 1.75 vs 2.25 (2LPT):",
             "4. Tsit5(tol=1e-3, adaptive) vs BullFrog(10) matter:", "3. float32 (cpu) vs float64"]
    lines = out.splitlines()
    for head in heads:
        (i,) = [j for j, line in enumerate(lines) if line.startswith(head)]
        nums = [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", lines[i + 1])]
        assert nums and np.isfinite(nums).all(), lines[i + 1]
    assert "the float64 run is the plain path on the CPU" in out
    section3 = lines[lines.index(next(x for x in lines if x.startswith(heads[3]))) + 1]
    assert float(section3.split("within ")[1].split()[0]) < 1e-4  # float32 vs float64
    assert "accepted" in out and "# report done" in out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        accuracy.main(["--final", "16"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        register.main(["synthetic", "--cell-budget", "512", "--n-ptcl", "16"])
