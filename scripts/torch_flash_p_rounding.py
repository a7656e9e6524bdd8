"""How rounding p to bf16 before P·V moves the flash kernel's bf16 outputs.

The port's ``wgmma`` flash kernel multiplies p into V on bf16 tensor
cores, while the TPU kernel and the port's plain version multiply a
float32 p.  This script emulates the two ways to feed p, on the CPU in
float32, and counts the bf16 outputs that then fall outside the card
tolerance the kernel is held to (atol 1e-4, rtol 2^-7):

* ``single``: p rounded once to bf16;
* ``split``: p as hi = bf16(p) plus lo = bf16(p - hi), both multiplied
  into a float32 sum (the kernel's design).

Inputs are the bf16 cases of ``tests/test_torch_gpu.py``'s
``test_flash_kernel_matches_plain`` with the same seeds; the emulation
takes the softmax over whole rows (the kernel's online softmax rounds p
tile by tile against a running max).  Run from the repository root:

    PYTHONPATH=src python scripts/torch_flash_p_rounding.py
"""
import numpy as np
import torch

from repro_torch.kernels.attention import NEG_INF, flash_attention_plain

#: (B, S, H, KV, D, window, softcap): test_flash_kernel_matches_plain's cases.
CASES = [
    (1, 512, 8, 4, 256, None, 50.0),
    (1, 700, 8, 4, 256, 256, 50.0),
    (2, 300, 16, 8, 128, None, None),
    (2, 77, 4, 2, 64, 16, 30.0),
    (1, 1, 2, 1, 64, None, None),
]
ATOL, RTOL = 1e-4, 2.0 ** -7


def _normal(seed, shape):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def emulate(q, k, v, window, softcap, split):
    """Attention with p fed to P·V in bf16 (``split``: as hi + lo), the
    sums and the normaliser in float32; the output rounded to bf16."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qr = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qr, k.float()) * (d ** -0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
    acc = sum(torch.einsum("bgrst,btgd->bsgrd", part, v.float()) for part in parts)
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]  # (b, s, g, r, 1)
    return (acc / l.clamp_min(1e-37)).reshape(b, s, h, d).bfloat16()


def main():
    print("case | outputs | single: outside, share, max err | split: outside, share, max err")
    for b, s, h, kv, d, window, cap in CASES:
        q, k, v = (_normal(i, (b, s, n, d)) for i, n in enumerate((h, kv, kv)))
        want = flash_attention_plain(q, k, v, window=window, logit_softcap=cap).float()
        row = [f"B={b} S={s} H={h} KV={kv} D={d} window={window} softcap={cap}", want.numel()]
        for split in (False, True):
            got = emulate(q, k, v, window, cap, split).float()
            err = (got - want).abs()
            outside = int((err > ATOL + RTOL * want.abs()).sum())
            row += [outside, f"{outside / want.numel():.2%}", f"{float(err.max()):.4g}"]
        print(" | ".join(str(x) for x in row))


if __name__ == "__main__":
    main()
