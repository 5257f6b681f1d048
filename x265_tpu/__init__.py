"""x265-tpu: an accelerator-native HEVC encoder framework.

A from-scratch re-design of the capabilities of the x265 HEVC encoder
(reference: x265 source, X265_BUILD 192) for accelerators driven by JAX:

- All pixel/transform/cost math runs as batched JAX/XLA computation
  over whole frames (the analog of x265's ``EncoderPrimitives`` SIMD table,
  reference source/common/primitives.h:237-432).
- Mode decisions are computed as dense candidate evaluation + argmin over a
  mode axis (the analog of x265's serial RDO loops in
  source/encoder/analysis.cpp / search.cpp).
- CABAC entropy coding is a per-slice/per-row serial *finalizer* fed by
  decision tensors (the analog of x265's compressCTU/encodeCTU split,
  source/encoder/frameencoder.cpp:1519,1533).
- Multi-device scaling uses jax.sharding meshes (frames/tiles axes) instead
  of x265's thread pools (source/common/threadpool.cpp).

Layout:
    api/       public parameter + encoder API (x265.h / api.cpp analog)
    hevc/      spec-level codec: bitstream, NAL, CABAC, headers, syntax
    decoder/   reference HEVC decoder (test/verification asset)
    ops/       batched compute kernels (jnp) + numpy references
    models/    jittable whole-frame encode graphs per configuration tier
    engine/    frame encoder orchestration, mode decision, DPB, rate control
    parallel/  device mesh, sharding, wavefront/pipeline schedules
    io/        Y4M/YUV readers, Annex-B writer
    utils/     logging, profiling
    native/    C++ components (CABAC finalizer) built as ctypes extensions
"""

__version__ = "0.1.0"
X265_TPU_BUILD = 1

# Persistent XLA compilation cache: the encoder compiles dozens of
# whole-frame programs, so every process after the first reloads them
# instead of recompiling. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache lives at one fixed path inside the checkout.
import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

from x265_tpu.api.params import Param, param_default, param_default_preset  # noqa: F401
