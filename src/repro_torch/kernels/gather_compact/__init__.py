from repro_torch.kernels.gather_compact.kernel import gather_compact_cuda
from repro_torch.kernels.gather_compact.ref import gather_compact_ref

__all__ = ["gather_compact_cuda", "gather_compact_ref"]
