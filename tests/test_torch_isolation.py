"""The port stands alone: importing it (the host parameter-server path,
checkpoints and sockets, the Spark-ML skin, the search, the resilience,
streaming and fleet packages and the package-level exports included) loads neither JAX, Keras nor any
module of the JAX package, and without CUDA its entry points refuse to run
unless the CPU is asked for (no quiet fallback), as does ``chip_smoke.py``."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
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
import elephas_tpu_torch.ops.flash_attention, elephas_tpu_torch.ops.paged_attention
import elephas_tpu_torch.serving.memory, elephas_tpu_torch.parallel
import elephas_tpu_torch.parallel.expert, elephas_tpu_torch.ops.grouped_matmul
import elephas_tpu_torch.ops.fused_xent, elephas_tpu_torch.models.losses
import elephas_tpu_torch.models.adapters, elephas_tpu_torch.parallel.mesh
import elephas_tpu_torch.parallel.engine, elephas_tpu_torch.spark_model
import elephas_tpu_torch.data, elephas_tpu_torch.mllib, elephas_tpu_torch.utils
import elephas_tpu_torch.worker, elephas_tpu_torch.parameter
import elephas_tpu_torch.parameter.native, elephas_tpu_torch.parameter.compression
import elephas_tpu_torch.native_build, elephas_tpu_torch.utils.sockets
import elephas_tpu_torch.utils.checkpoint, elephas_tpu_torch.utils.functional_utils
import elephas_tpu_torch.ml_model, elephas_tpu_torch.hyperparam, elephas_tpu_torch.dl4j
import elephas_tpu_torch.ml, elephas_tpu_torch.ml.params, elephas_tpu_torch.data.dataframe
from elephas_tpu_torch import (load_spark_model, ElephasEstimator, ElephasTransformer,
                               load_ml_estimator, load_ml_transformer, HyperParamModel)
from elephas_tpu_torch.utils import save_checkpoint
from elephas_tpu_torch.parallel import EXPERT_AXIS
from elephas_tpu_torch.data import DataFrame, Row, SparkSession
from elephas_tpu_torch.ml import Pipeline
from elephas_tpu_torch.serving import ModelDrafter, NgramDrafter
from elephas_tpu_torch.models.transformer import spec_round_accept, spec_verify_select
from elephas_tpu_torch.models.transformer import write_prompt_cache
from elephas_tpu_torch.models import build_lm_train_phases, generate_beam
import elephas_tpu_torch.models.beam
import elephas_tpu_torch.resilience, elephas_tpu_torch.streaming, elephas_tpu_torch.fleet
import elephas_tpu_torch.resilience.soak, elephas_tpu_torch.resilience.supervisor
from elephas_tpu_torch.resilience import FaultPlan, TrainingSupervisor, run_soak
from elephas_tpu_torch.streaming import WeightPublisher, engine_sink, list_to_params
from elephas_tpu_torch.fleet import FleetRouter, TrafficModel, Autoscaler
for obj in (FaultPlan, TrainingSupervisor, run_soak, WeightPublisher, engine_sink,
            list_to_params, FleetRouter, TrafficModel, Autoscaler):
    assert obj.__module__.split(".")[0] == "elephas_tpu_torch", obj
for obj in (load_spark_model, ElephasEstimator, ElephasTransformer, load_ml_estimator,
            load_ml_transformer, HyperParamModel, save_checkpoint, DataFrame, Row,
            SparkSession, Pipeline, ModelDrafter, NgramDrafter, spec_round_accept,
            spec_verify_select, write_prompt_cache, build_lm_train_phases,
            generate_beam):
    assert obj.__module__.split(".")[0] == "elephas_tpu_torch", obj
assert EXPERT_AXIS == "expert"
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


def test_mlp_fit_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.models import KerasModelAdapter

    config = (ROOT / "elephas_tpu_torch" / "configs" / "mnist_mlp_logits.json").read_text()
    with pytest.raises(RuntimeError, match="CUDA"):
        SparkModel(config, mode="synchronous")
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelAdapter(config)
    sm = SparkModel(config, mode="synchronous", device="cpu")     # asked for: fine
    assert sm.master_network.get_weights()[0].shape == (784, 128)


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


def test_skin_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    from elephas_tpu_torch import (ElephasEstimator, ElephasTransformer, HyperParamModel,
                                   load_ml_estimator, load_ml_transformer)
    from elephas_tpu_torch.data import SparkContext

    sc = SparkContext("local[2]")
    for make in (ElephasEstimator, ElephasTransformer, lambda: HyperParamModel(sc)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    ElephasEstimator(device="cpu", epochs=2).save(str(tmp_path / "e.npz"))
    ElephasTransformer(device="cpu").save(str(tmp_path / "t.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_ml_estimator(str(tmp_path / "e.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_ml_transformer(str(tmp_path / "t.npz"))
    assert load_ml_estimator(str(tmp_path / "e.npz"), device="cpu").get_epochs() == 2
    HyperParamModel(sc, device="cpu")     # asked for: fine
