from .kernel import flash_decode_kernel
from .ops import flash_decode
from .ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_kernel", "flash_decode_ref"]
