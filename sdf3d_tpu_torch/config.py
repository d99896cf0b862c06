"""Static render configuration (the port of ``sdf3d_tpu/config.py``).

Frozen dataclasses with the JAX package's field names and defaults, so a
JAX config converts field for field (``convert.from_jax``) and a setup file
written by either package loads in the other (``sdf.io``).  The march,
shadow and AO constants are compile-time constants of the CUDA render
kernel (``ops/scene_program.py`` emits them as ``constexpr``), as they are
static ``jit`` arguments in JAX; image width and height are run-time kernel
arguments.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Primary sphere-trace march parameters."""

    max_steps: int = 100
    max_distance: float = 100.0
    epsilon: float = 0.01
    #: Stop a march once every ray has terminated; ``False`` runs every step
    #: (bitwise identical, never exits early).
    early_exit: bool = True
    #: Over-relaxed sphere tracing (Keinert et al. 2014): step ``ω·s`` and
    #: fall back to ``ω = 1`` once consecutive bounding spheres stop
    #: overlapping.  ``1.0`` is the reference's exact march; the torch march,
    #: K1-K4 and their plain versions take other values (the neural kernel
    #: marches exactly, as JAX's).
    relaxation: float = 1.0


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Quilez improved soft-shadow march; the shadow ray starts at
    ``hit + 2·epsilon·normal``."""

    enabled: bool = True
    k: float = 10.0
    max_steps: int = 100
    #: Gradient treatment of the shadow march (kept for config parity; the
    #: port is forward only).
    grad: str = "detach"


@dataclasses.dataclass(frozen=True)
class AOConfig:
    """SDF ambient occlusion: ``samples`` taps along the normal at
    ``i·step``, weighted by ``falloff**(i-1)``, scaling the ambient term by
    ``clamp(1 - strength·occlusion, 0, 1)``."""

    enabled: bool = False
    samples: int = 5
    step: float = 0.05
    falloff: float = 0.7
    strength: float = 3.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full pipeline configuration.

    ``ray_mode``: ``"reference"`` keeps the reference's ray z-term
    ``-2/tan(fov·π/360)``; ``"pinhole"`` is the standard ``-1/tan(fov/2)``.
    ``normals``: ``"central"`` (6 taps), ``"tetrahedron"`` (4 taps) or
    ``"autodiff"`` (the distance's gradient: the torch engine only; the
    kernels raise ``ValueError``, as JAX's Pallas path).  ``background``: ``None`` shades rays
    beyond ``max_distance`` at their far point (the reference has no miss
    branch); an RGB tuple composites misses over that colour.
    """

    width: int = 800
    height: int = 600
    #: NDC extent overrides for row-slab rendering; ``None`` means the
    #: output extent.
    ndc_height: int | None = None
    ndc_width: int | None = None
    march: MarchConfig = MarchConfig()
    shadow: ShadowConfig = ShadowConfig()
    ao: AOConfig = AOConfig()
    normals: str = "central"
    ray_mode: str = "reference"
    shading: str = "blinn_phong"  # or "lambert"
    background: tuple | None = None

    @property
    def aspect_ratio(self) -> float:
        """Framebuffer aspect ratio ``W/H``."""
        return self.width / self.height


#: The reference app's fixed choices: 800×600, 100-step marches, ε = 0.01,
#: k = 10 shadows, central normals, Blinn-Phong, no AO.
REFERENCE_CONFIG = RenderConfig()


def fast_config(base: RenderConfig = REFERENCE_CONFIG) -> RenderConfig:
    """The non-parity fast profile: tetrahedron normals and a 32-step
    shadow march (same choices as the JAX package's ``fast_config``)."""
    return dataclasses.replace(
        base,
        normals="tetrahedron",
        shadow=dataclasses.replace(base.shadow, max_steps=32),
    )
