"""Plain torch versions of the kernels (the allclose references).

Each one repeats its kernel's arithmetic step by step in f32 and casts the
result back to the input dtype, so the CUDA kernel is held bit-for-bit
against it on the card and the CPU path computes the same numbers.
"""

from __future__ import annotations

import torch


def reference_gossip_mix(x, u, pulled, w):
    """out = (1-w)*(x+u) + w*pulled (f32 math, cast back); w scalar."""
    wf = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    xf = x.float() + u.float()
    out = (1.0 - wf) * xf + wf * pulled.float()
    return out.to(x.dtype)


def reference_gossip_mix_rows(x, u, pulled, w):
    """Per-row mix: out[r] = (1-w[r])*(x[r]+u[r]) + w[r]*pulled[r].

    x/u/pulled: (R, ...); w: (R,) broadcast over the trailing dims.
    """
    wf = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    wf = wf.reshape((-1,) + (1,) * (x.ndim - 1))
    xf = x.float() + u.float()
    out = (1.0 - wf) * xf + wf * pulled.float()
    return out.to(x.dtype)
