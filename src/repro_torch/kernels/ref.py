"""Dense PyTorch oracle for the flash kernels (tests only)."""
from __future__ import annotations

from repro_torch.core.attention import attention_dense_oracle


def flash_attention_ref(q, k, v, q_seg, k_seg, q_pos, k_pos, *, scale,
                        causal=True, window=0, softcap=0.0):
    """q [G, Hg, T, Dk], k/v [G, S, D*] -> out [G, Hg, T, Dv] (kernel layout).
    Delegates to the core dense oracle in its [T, G, Hg, D] layout."""
    out = attention_dense_oracle(
        q.permute(2, 0, 1, 3), k.permute(1, 0, 2), v.permute(1, 0, 2),
        q_seg, k_seg, q_pos, k_pos, scale=scale, causal=causal,
        window=window, softcap=softcap)
    return out.permute(1, 2, 0, 3)
