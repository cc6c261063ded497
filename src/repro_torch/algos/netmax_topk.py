"""NetMax + top-k sparsified pulls (SAPS-style; Tang et al., 2020).

NetMax's adaptive peer selection (Alg. 3 policy, gamma-weighted mixing)
combined with sparsifying the consensus delta ``w * (x_pull - x_half)``
before it crosses the link, via ``core/compression.py``'s top-k operator:

* **mixing** — only the k largest-magnitude delta entries move;
* **timing** — wire bytes shrink to ~2*ratio of a dense f32 pull (value +
  index per kept entry), so slow links cost proportionally less virtual time.
"""

from __future__ import annotations

from repro_torch.algos.base import register
from repro_torch.algos.netmax import NetMax
from repro_torch.core.compression import topk_mask


@register("netmax-topk")
class NetMaxTopK(NetMax):
    """NetMax peer selection, top-k sparsified consensus delta."""

    def __init__(self, ratio: float = 0.05):
        super().__init__()
        assert 0.0 < ratio <= 1.0
        self.ratio = float(ratio)

    def delta_transform(self, delta):
        flat = delta.reshape(-1)
        k = max(1, int(self.ratio * flat.numel()))
        return topk_mask(flat, k).reshape(delta.shape)

    def wire_ratio(self) -> float:
        # value + int32 index per kept entry vs dense f32.
        return min(1.0, 2.0 * self.ratio)
