"""Hand-written CUDA kernels for the exit machinery, each beside its plain
PyTorch version.

exit_decision   -- the Exit Decision layer (section III-C.1, Eq. 4) as one
                   streamed reduction over the vocab.
gather_compact  -- stream compaction; the Conditional Buffer (III-C.2).
fused_dispatch  -- decision + slot map + ring scatter-merge, the in-ring
                   enqueue of the serving loop.
paged_attention -- the paged decode cache: tail-page append, then a gather
                   of every row's pages.
flash_attention -- blocked causal / windowed GQA attention with the online
                   softmax, the per-shard core of the mesh prefill path.

Each subpackage holds kernel.py (the wrapper that launches the CUDA kernel
from ``csrc/`` and counts its launches) and ref.py (the plain version).
``dispatch`` picks between them by the tensors' device.
"""
