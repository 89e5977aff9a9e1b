"""Why the bf16 flash-attention kernel splits p before the PV product.

The kernel's bf16 gate is |got - want| <= 2^-7 |want| + 1e-4 per element
against the plain version (``flash_attention/ref.py``), which multiplies
fp32 p into v, as the TPU kernel does. This script redoes, with plain
PyTorch arithmetic on the CPU, three ways a tensor-core kernel can form
the output from bf16 q, k and v (products of bf16 values exact in fp32,
fp32 sums), and prints the share of elements past the gate at the mesh
prefill cell's shard shapes (qwen2-1.5b: 12 query heads over 2 kv heads
of 128):

* ``bf16_p``  -- s from (q * scale) . k, p rounded to bf16 before PV;
* ``split_p`` -- the kernel's: s from unscaled q, the scale and log2 e
  applied to s in fp32 inside exp2, p = hi + lo with hi = bf16(p) and
  lo = bf16(p - hi), both products summed in fp32;
* ``fp32_p``  -- s as in ``split_p``, PV on the fp32 p.

    PYTHONPATH=src python tools/flash_p_study.py      # a few minutes
"""
import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref

RTOL, ATOL = 2.0 ** -7, 1e-4          # the kernel's bf16 gate
SHAPES = {"seq shard": (1, 2048, 4096, 2048),      # B, Sq, Sk, q_offset
          "batch shard": (16, 512, 512, 0)}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate(variant, q, k, v, q_offset):
    """The causal output of one arithmetic ``variant``, rounded to bf16."""
    B, H, Sq, D = q.shape
    G, Sk = H // k.shape[1], k.shape[2]
    scale = D ** -0.5
    sl2 = scale * math.log2(math.e)
    mask = (q_offset + torch.arange(Sq)[:, None]) >= torch.arange(Sk)[None]
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    for b in range(B):
        for h in range(H):
            qf, kf = q[b, h].float(), k[b, h // G].float()
            vf = v[b, h // G].float()
            if variant == "bf16_p":
                s = ((qf * scale) @ kf.T).masked_fill(~mask, -math.inf)
                p = torch.exp(s - s.amax(-1, keepdim=True))
                o = _bf16(p) @ vf
            else:
                s = (qf @ kf.T).masked_fill(~mask, -math.inf)
                p = torch.exp2(s * sl2 - s.amax(-1, keepdim=True) * sl2)
                if variant == "split_p":
                    hi = _bf16(p)
                    o = hi @ vf + _bf16(p - hi) @ vf
                else:
                    o = p @ vf
            out[b, h] = (o / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    return out


def main():
    torch.set_num_threads(4)
    for name, (B, Sq, Sk, off) in SHAPES.items():
        # normal values rounded to bf16, as chip_smoke.py makes them
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape,
                                                        dtype=np.float32))
                   .to(torch.bfloat16)
                   for shape in ((B, 12, Sq, 128), (B, 2, Sk, 128),
                                 (B, 2, Sk, 128)))
        want = flash_attention_ref(q, k, v, off).float()
        for variant in ("bf16_p", "split_p", "fp32_p"):
            d = (emulate(variant, q, k, v, off).float() - want).abs()
            share = (d > RTOL * want.abs() + ATOL).float().mean().item()
            print(f"{name} q {tuple(q.shape)} at offset {off} vs k/v "
                  f"{tuple(k.shape)}, {variant}: {100 * share:.4f} % of "
                  f"elements past the gate, max err {d.max().item():.3g}")


if __name__ == "__main__":
    main()
