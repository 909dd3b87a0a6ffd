"""tpusph_torch — the tpusph SPH engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `tpusph`, which stays the reference: the same
module layout and names, the same physics and float32 constants. Plain
tensor code is PyTorch; the rank, density and force passes are CUDA
kernels under `csrc/`, built with nvcc at first use. Each kernel has a
plain PyTorch version beside it, which CPU tensors take.
"""

from tpusph_torch.core.config import SimConfig, default_config, tuned_config
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FluidState, make_state
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.engine.step import make_step, step_allpairs, step_kernels

__all__ = [
    "SimConfig",
    "default_config",
    "tuned_config",
    "FluidState",
    "make_state",
    "init_state",
    "Simulator",
    "make_step",
    "step_allpairs",
    "step_kernels",
]

__version__ = "0.1.0"
