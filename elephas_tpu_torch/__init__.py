"""PyTorch/CUDA port of ``elephas_tpu`` for NVIDIA Hopper (H100).

The JAX package ``elephas_tpu`` is the reference; this package ports it
slice by slice with the same parameter names, layouts and semantics. Every
Pallas kernel of a ported slice becomes a hand-written CUDA kernel under
``ops/csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Ported so far: the dense serving path, :class:`~.models.TransformerLM`
(``decode_step`` / ``decode_chunk`` / ``prefill_slot``) under
:class:`~.serving.ServingEngine`, with the fused LayerNorm and flash-decode
kernels; and LM training and generation (``apply``,
``build_lm_train_step``, the optimizers, ``prefill``, ``generate``), with
the flash-attention kernels (forward, dq, dkv) and the LayerNorm backward;
and paged serving (``ServingEngine(paged=True)``: block allocator, radix
prefix cache, preemption), with the paged-attention kernels (decode and
chunk); the mixture-of-experts LM, with the grouped-matmul kernels; and
the Keras MLP fit (:class:`SparkModel` over the compiled path's engine and
a Keras-free adapter of the model's JSON), with the fused
classification-loss kernels; and the fit's host parameter-server path
(``SparkModel``'s reference defaults: worker threads training replicas on
the device against HTTP, socket or native servers, ``worker.py`` and
``parameter/``), checkpoints and ``save`` / ``load_spark_model``; and the
Keras layers of the repo's examples (Reshape, Conv1D/Conv2D, MaxPooling2D,
BatchNormalization with its moving statistics merged across workers,
Embedding, LSTM) on every fit path; and the API skins around
``SparkModel``: the Spark-ML estimator and transformer over the local
``DataFrame`` (``ml_model.py``, ``ml/``, ``data/dataframe.py``), the
distributed hyperparameter search (``hyperparam.py``) and the DL4J
aliases (``dl4j.py``).

Device policy: every entry point takes ``device=`` and defaults to
``"cuda"``. Without a CUDA device the entry points raise unless the caller
asks for the CPU explicitly; nothing falls back quietly. Kernel wrappers
pick by the tensor they are given: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the kernel or raises.

Isolation: this package imports ``torch`` and ``numpy`` only — never
``jax``, ``keras`` or any ``elephas_tpu`` module (framework-free helpers
it needs are copied).
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises :class:`RuntimeError` for a CUDA device when CUDA is absent: the
    port never carries on on the CPU unless the caller asked for it. On the
    card, float32 matmuls are pinned to full float32 (no TF32): the JAX
    reference runs them at ``Precision.HIGHEST``, and TF32 keeps only about
    three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:   # "cuda" and "cuda:0" must compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


from .hyperparam import HyperParamModel  # noqa: E402
from .ml_model import (ElephasEstimator, ElephasTransformer,  # noqa: E402
                       load_ml_estimator, load_ml_transformer)
from .spark_model import SparkMLlibModel, SparkModel, load_spark_model  # noqa: E402

__all__ = ["SparkModel", "SparkMLlibModel", "load_spark_model", "ElephasEstimator",
           "ElephasTransformer", "load_ml_estimator", "load_ml_transformer",
           "HyperParamModel", "__version__", "resolve_device"]
