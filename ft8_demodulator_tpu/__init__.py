"""ft8_demodulator_tpu: an FT8 signal-processing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
FT8 demodulator (Rintazero/ft8_demodulator): TX generation, waterfall
demodulation with soft LDPC decoding, satellite-channel simulation, and
frequency-drift correction — built as fixed-shape jitted kernels that batch
and shard over device meshes, on the CPU or NVIDIA GPUs.
"""

__version__ = "0.3.0"

# opt-in NaN sanitizer (SURVEY §5): FT8_DEBUG_NANS=1 makes every jitted
# stage raise at the first NaN it produces
from .utils.debug import init_from_env as _init_nan_debug

_init_nan_debug()
del _init_nan_debug
