# encodermap_tpu_torch/data/native/__init__.py
"""Native (C++) IO of the port: the XTC codec, built with g++ on first use
and bound with ctypes (counterpart of ``encodermap_tpu/data/native``)."""

from .build import load_library

__all__ = ["load_library"]
