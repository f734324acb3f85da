"""The port stands alone: importing it loads neither JAX, Keras nor any
module of the JAX package, and without CUDA its entry points refuse to run
unless the CPU is asked for (no quiet fallback), as does ``chip_smoke.py``."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import elephas_tpu_torch, elephas_tpu_torch.ops, elephas_tpu_torch.models
import elephas_tpu_torch.serving, elephas_tpu_torch.models.optimizers
import elephas_tpu_torch.ops.flash_attention
bad = sorted(m for m in sys.modules
             if m in ("jax", "keras", "elephas_tpu")
             or m.startswith(("jax.", "keras.", "elephas_tpu.")))
print(",".join(bad))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, from_jax_params,
                                          make_lm_batches)
    from elephas_tpu_torch.serving import ServingEngine

    cfg = dict(vocab=11, d_model=8, n_heads=2, n_layers=1, d_ff=16,
               max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(**cfg)
    model = TransformerLM(**cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"tok": np.zeros((2, 2), np.float32)})
    ServingEngine(model, params, device="cpu")     # asked for: fine
    # training and generation run where the params are: CPU params stay on
    # the CPU, and nothing moves them to another device
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3),
                                         attn="flash")
    tok, pos, tg = make_lm_batches(np.zeros((2, 9), np.int32))
    new, _, loss = step(params, opt_init(params), tok, pos, tg)
    assert loss.device.type == "cpu" and new["tok"].device.type == "cpu"
    assert model.generate(params, tok, 2).device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(no_cuda, tmp_path):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # ... and alone, outside the repository
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
