"""Plain torch versions of the kernels (the allclose references).

Each one computes in f32 and casts the result back to the input dtype.
The gossip-mix references repeat their kernel's arithmetic step by step, so
that kernel is held bit-for-bit against them on the card; the attention
reference materialises the (S, Sk) scores and is held to the flash kernel
with the float tolerances of ``tests/test_kernels.py``, and its autograd
gradient to the backward kernels; the RWKV reference
is the sequential recurrence, held to the chunked kernel the same way, and
its explicit reverse recurrence to the WKV backward kernel.
"""

from __future__ import annotations

import math

import torch


def reference_gossip_mix(x, u, pulled, w):
    """out = (1-w)*(x+u) + w*pulled (f32 math, cast back); w scalar."""
    wf = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    xf = x.float() + u.float()
    out = (1.0 - wf) * xf + wf * pulled.float()
    return out.to(x.dtype)


def reference_gossip_mix_rows(x, u, pulled, w):
    """Per-row mix: out[r] = (1-w[r])*(x[r]+u[r]) + w[r]*pulled[r].

    x/u/pulled: (R, ...); w: (R,) broadcast over the trailing dims.  u None
    means u = 0, computed as x + 0.0 (so -0.0 becomes +0.0, as x + zeros and
    the u-less kernel give).
    """
    wf = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    wf = wf.reshape((-1,) + (1,) * (x.ndim - 1))
    xf = x.float() + (0.0 if u is None else u.float())
    out = (1.0 - wf) * xf + wf * pulled.float()
    return out.to(x.dtype)


def reference_attention(q, k, v, *, causal: bool = True):
    """Naive O(S^2) GQA attention. q: (B,S,H,hd); k/v: (B,Sk,Hk,hd).

    f32 math, cast back to q's dtype; the causal mask aligns query and key
    positions from 0 (``q_pos >= k_pos``), masked scores are -1e30."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, hd).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bshgd,bkhd->bhgsk", qg, kf) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgsk,bkhd->bshgd", p, vf)
    return o.reshape(B, S, H, hd).to(q.dtype)


def reference_attention_backward(q, k, v, dout, *, causal: bool = True):
    """(dq, dk, dv) of ``reference_attention`` for the output gradient
    ``dout``: ``torch.autograd.grad`` through it, so in f32 from the inputs'
    casts, with dk and dv summed over the G query heads of their KV head in
    f32 and cast to the input dtype once."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = reference_attention(qq, kk, vv, causal=causal)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def reference_rwkv(r, k, v, w, u):
    """Sequential WKV recurrence.  r/k/v/w: (B,S,H,N); u: (H,N).

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    return reference_rwkv_state(r, k, v, w, u)[0]


def reference_rwkv_state(r, k, v, w, u, state=None):
    """``reference_rwkv`` from the initial state (B,H,N,N) f32 (zeros when
    None) -> (y in r's dtype, the final state f32).

    Mixed inputs (bf16 r/k/v with f32 w, as the model passes on the card)
    are widened to f32 exactly, as the kernel does, and y is rounded to r's
    dtype once at the end."""
    B, S, H, N = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    st = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], st + uf * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1).to(r.dtype), st


def reference_rwkv_backward(r, k, v, w, u, state, dy, dstate):
    """The gradient of ``reference_rwkv_state``: (dr, dk, dv, dw, du, dstate0)
    for the output gradient ``dy`` (B,S,H,N) and the final-state gradient
    ``dstate`` (B,H,N,N) f32 (zeros when None), from the initial ``state``
    (zeros when None).

    An explicit reverse recurrence in f32, one step a token, with S_{t-1}
    the state before token t and G_t the adjoint of the state after it
    (G_T = dstate):

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
        dk_t = u r_t (v_t . dy_t) + G_t v_t
        dv_t = (r_t . (u k_t)) dy_t + G_t^T k_t
        dw_t = rowsum(G_t * S_{t-1})
        du  += r_t k_t (v_t . dy_t)                  (summed over b and t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,        dstate0 = G_0

    dr, dk and dv come back in r's dtype, dw in w's, du and dstate0 in f32."""
    B, S, H, N = r.shape
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()[None]  # (1,H,N)
    st = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    before = []
    for t in range(S):
        before.append(st)
        st = wf[:, t, :, :, None] * st + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    G = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.float())
    dr, dk, dv, dw = (torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.zeros((H, N), dtype=torch.float32, device=r.device)
    for t in reversed(range(S)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))  # (B,H,N)
        prev = before[t]
        vdy = (vt * dyt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhnm,bhm->bhn", prev, dyt) + uf * kt * vdy
        dk[:, t] = uf * rt * vdy + torch.einsum("bhnm,bhm->bhn", G, vt)
        dv[:, t] = ((rt * uf * kt).sum(-1, keepdim=True) * dyt
                    + torch.einsum("bhnm,bhn->bhm", G, kt))
        dw[:, t] = (G * prev).sum(-1)
        du += (rt * kt * vdy).sum(0)
        G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype), du, G)


def clamp_decay(w, chunk: int = 64):
    """The decays the JAX package's Pallas RWKV kernel sees: per-step log
    decay clamped to ``>= -75 / min(16, chunk)`` (``repro/kernels/rwkv_scan.py``'s
    wrapper), in f32.  Neither the JAX model nor the port's CUDA kernel
    clamps; this only lets the plain version be held against that kernel."""
    bound = 75.0 / min(16, chunk)
    return torch.exp(torch.clamp(torch.log(torch.clamp(w.float(), min=1e-30)), -bound, 0.0))
