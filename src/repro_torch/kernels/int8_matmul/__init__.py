from .kernel import int8_matmul_kernel
from .ops import int8_matmul
from .ref import int8_matmul_ref

__all__ = ["int8_matmul", "int8_matmul_kernel", "int8_matmul_ref"]
