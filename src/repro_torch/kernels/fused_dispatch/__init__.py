from repro_torch.kernels.fused_dispatch.kernel import (fused_dispatch_cuda,
                                                       scatter_merge_cuda,
                                                       slot_src_map)
from repro_torch.kernels.fused_dispatch.ref import (compact_src,
                                                    fused_dispatch_ref,
                                                    ring_offsets,
                                                    scatter_merge_ref)

__all__ = ["compact_src", "fused_dispatch_cuda", "fused_dispatch_ref",
           "ring_offsets", "scatter_merge_cuda", "scatter_merge_ref",
           "slot_src_map"]
