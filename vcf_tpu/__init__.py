"""vcf_tpu — a visual coding framework on the accelerator, in JAX.

A from-scratch re-design of the capabilities of Sistemas-Multimedia/VCF
(reference: /root/reference) for an accelerator (an NVIDIA GPU):

* all pixel math (color transforms, block transforms, quantization,
  motion search) runs on device as jittable JAX / Pallas code;
* entropy coding runs in a native C++ runtime on the host (with pure
  NumPy fallbacks) because bitstream serialization is inherently
  sequential per stream;
* composition is explicit functional configuration (`CodecConfig`)
  instead of the reference's dynamic-inheritance-over-argv
  (reference: src/2D-DCT.py:54-56, src/YCoCg.py:20-23);
* parallelism is data-parallel sharding of frames / tiles / GOPs over a
  `jax.sharding.Mesh` (the reference is single-process; see SURVEY §2.4).

Public API:

    from vcf_tpu import CodecConfig, Codec
    codec = Codec(CodecConfig(spatial="dct", color="ycocg",
                              quantizer="deadzone", entropy="huffman"))
    stream = codec.encode(img)          # CodeStream (bytes + side info)
    rec    = codec.decode(stream)       # uint8 image
"""

from vcf_tpu.config import CodecConfig, VideoConfig
from vcf_tpu.pipeline import Codec
from vcf_tpu.codestream import CodeStream
from vcf_tpu import metrics

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "VideoConfig",
    "Codec",
    "CodeStream",
    "metrics",
    "__version__",
]
