"""Simulation configuration: the reference's `Settings` struct plus its
compile-time physics constants, as a frozen dataclass.

Counterpart of `tpusph/core/config.py`. The physics fields, the derived
constants and their float32 rounding are the same, so both packages feed
their kernels bit-equal constants. The JAX package's `pallas_*` fields
and its per-N `tuned_overrides` presets describe the TPU kernels' memory
layout and were measured on a TPU; they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import struct

PI = 3.14159265  # reference: simulator.h:6 (float literal 3.14159265f)
EPS_F = 1e-4  # reference: simulator.cu:14

MAX_PARTICLES_DEFAULT = 1000  # reference default -n (main.cpp:21)


def f32(x: float) -> float:
    """Round a python float through float32. Kernel constants are passed in
    this form, so every consumer (a torch op, a CUDA kernel) sees the exact
    float32 value the JAX package computes with `jnp.float32(...)`."""
    return struct.unpack("f", struct.pack("f", x))[0]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static physics and scene configuration."""

    num_particles: int = MAX_PARTICLES_DEFAULT
    h: float = 0.1  # smoothing radius (main.cpp:57)
    box_dim: float = 10.0  # main.cpp:62
    num_cells_per_dim: int = 100  # box_dim / h (main.cpp:62)
    dt: float = 0.01  # main.cpp:62
    mass: float = 0.02  # simulator.h:7
    gas_constant: float = 1.0  # simulator.h:8
    rest_density: float = 1000.0  # simulator.h:9
    viscosity: float = 1.0  # simulator.h:10
    gravity: float = -9.8  # simulator.h:11
    elasticity: float = 0.5  # simulator.h:12
    eps: float = EPS_F

    # Capacity fields of the JAX package's window and tile passes, kept so a
    # config round-trips between the packages. The CUDA kernels walk every
    # window to its end and have no capacity.
    window_capacity: int = 48
    tile_size: int = 256
    tile_cand_capacity: int = 768
    # Targets per chunk of the plain (padded-gather) density and force
    # passes; bounds their peak memory. Also sets the padding granularity.
    chunk_size: int = 8192

    @property
    def h2(self) -> float:
        return f32(self.h) * f32(self.h)

    @property
    def v_kernel_coeff(self) -> float:
        """45/(π h⁶), shared by the spiky gradient and the viscosity
        Laplacian (main.cpp:59)."""
        return f32(45.0 / (PI * self.h**6))

    @property
    def d_kernel_coeff(self) -> float:
        """315/(64 π h⁹), the poly6 coefficient (main.cpp:60)."""
        return f32(315.0 / (64.0 * PI * self.h**9))

    @property
    def num_cells(self) -> int:
        return self.num_cells_per_dim**3

    @property
    def padded_num_particles(self) -> int:
        """Particle slots, rounded up to a multiple of the chunk size.
        Extra slots are invalid and carry the sentinel key."""
        c = min(self.chunk_size, _round_up(self.num_particles, 256))
        return _round_up(self.num_particles, c)

    def validate(self) -> None:
        if self.num_particles <= 0:
            raise ValueError("num_particles must be positive")
        if self.h <= 0 or self.box_dim <= 0 or self.dt <= 0:
            raise ValueError("h, box_dim, dt must be positive")
        for f in ("window_capacity", "tile_size", "tile_cand_capacity", "chunk_size"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def default_config(num_particles: int = MAX_PARTICLES_DEFAULT, **kw) -> SimConfig:
    """The reference's scene: h=0.1 in a 10×10×10 box with a 100³ grid and
    dt=0.01 (main.cpp:57-63)."""
    cfg = SimConfig(num_particles=num_particles, **kw)
    cfg.validate()
    return cfg


def tuned_config(num_particles: int = MAX_PARTICLES_DEFAULT, **kw) -> SimConfig:
    """The config the CLI and the timed run use. The port has no per-N
    presets yet (the JAX package's are TPU kernel layouts), so this is
    `default_config`; it is the place where measured presets will go."""
    return default_config(num_particles, **kw)


def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from `dataclasses.asdict` of either package's config. The
    JAX package's `pallas_*` keys are dropped; any other unknown key is an
    error."""
    return SimConfig(**{k: v for k, v in d.items() if not k.startswith("pallas_")})
