from repro_torch.kernels.paged_attention.kernel import \
    paged_gather_append_cuda
from repro_torch.kernels.paged_attention.ref import paged_gather_append_ref

__all__ = ["paged_gather_append_cuda", "paged_gather_append_ref"]
