"""SoC overlap-vacuum sweep: kernel A (csrc/soc_sweep.cu) and its plain
PyTorch version (port of ma_tpu/ops/soc_pallas.py and of the XLA
while_loop in ma_tpu/ops/soc.py:185-290).

Per read, candidates are walked in delta order with a monotonic stack:
overlapping strips resolve by SoCOrder (length, tie -> higher ambiguity is
less); the lower strip shrinks through the carried prefix sums; strips
below min_score drop; the inner vacuum loop is bounded by K + 2 steps.
"""
from __future__ import annotations

import torch

from ma_tpu_torch import kernels


def _order_less(len_a, amb_a, len_b, amb_b):
    """SoCOrder::operator< (soc.h:71-76): by length, tie -> HIGHER amb is less."""
    return torch.where(len_a == len_b, amb_a > amb_b, len_a < len_b)


def soc_sweep_plain(cand_all: torch.Tensor, n: torch.Tensor,
                    min_score: torch.Tensor, K: int):
    """cand_all [S, B, 7] int32 (sl, sa, we, pexs, aexs, pend, aend per
    candidate), n [B], min_score [B] -> (stack [B, K, 8] int32, sp [B] int32,
    overflow [B] bool). Stack planes: start, end, len, amb, pexs, pend,
    aexs, aend. Slots past sp keep what a dropped strip left there (zeros
    where nothing was ever pushed). All reads advance in lockstep over the
    candidate index."""
    S, B, _ = cand_all.shape
    dev = cand_all.device
    st = torch.zeros((B, K, 8), dtype=torch.int32, device=dev)
    sp = torch.zeros(B, dtype=torch.int32, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    krange = torch.arange(K, device=dev)[None, :]
    n_max = int(n.max()) if B else 0
    for i in range(n_max):
        sl, sa, we, pexs, aexs, pend, aend = cand_all[i].unbind(1)
        # candidates below min score are skipped (stripOfConsideration.cpp:137-141)
        done = ~((i < n) & (sl >= min_score) & (sl > 0))
        c_start = torch.full_like(sl, i)
        c_len, c_amb, c_pexs, c_aexs = sl, sa, pexs, aexs
        it = 0
        while it < K + 2 and bool((~done).any()):
            sp1 = torch.clamp(sp - 1, min=0)
            at_top = krange == sp1[:, None]
            top = torch.where(at_top[:, :, None], st, 0).sum(1, dtype=torch.int32)
            (top_start, top_end, top_len, top_amb,
             top_pexs, top_pend, top_aexs, top_aend) = top.unbind(1)
            act = ~done
            overlap = act & (sp > 0) & (top_end > c_start)
            back_lower = _order_less(top_len, top_amb, c_len, c_amb)
            # case A: back strip is lower -> shrink it to [back_start, c_start)
            case_a = overlap & back_lower
            a_len = c_pexs - top_pexs
            a_amb = c_aexs - top_aexs
            drop_back = case_a & ((a_len < min_score) | (a_len <= 0))
            shrink_back = case_a & ~drop_back
            # case B: candidate is lower -> shrink it to [back_end, c_end)
            case_b = overlap & ~back_lower
            b_len = pend - top_pend
            b_amb = aend - top_aend
            keep_b = case_b & ~((b_len < min_score) | (b_len <= 0))

            top_new = torch.stack(
                [top_start, c_start, a_len, a_amb, top_pexs, c_pexs, top_aexs, c_aexs], -1
            )
            st = torch.where((at_top & shrink_back[:, None])[:, :, None],
                             top_new[:, None, :], st)
            p_start = torch.where(keep_b, top_end, c_start)
            p_len = torch.where(keep_b, b_len, c_len)
            p_amb = torch.where(keep_b, b_amb, c_amb)
            p_pexs = torch.where(keep_b, top_pend, c_pexs)
            p_aexs = torch.where(keep_b, top_aend, c_aexs)
            push_l = act & (~overlap | shrink_back | keep_b)
            can_push = push_l & (sp < K)
            cand_new = torch.stack(
                [p_start, we, p_len, p_amb, p_pexs, pend, p_aexs, aend], -1
            )
            at_slot = krange == torch.clamp(sp, max=K - 1)[:, None]
            st = torch.where((at_slot & can_push[:, None])[:, :, None],
                             cand_new[:, None, :], st)
            sp = sp + can_push.to(torch.int32) - drop_back.to(torch.int32)
            over = over | (push_l & ~can_push)
            done = done | (act & ~drop_back)
            c_start, c_len, c_amb, c_pexs, c_aexs = p_start, p_len, p_amb, p_pexs, p_aexs
            it += 1
    return st, sp, over


def soc_sweep(cand_all: torch.Tensor, n: torch.Tensor, min_score: torch.Tensor,
              K: int):
    """The sweep on the tensors' device: the plain version for CPU tensors,
    kernel A for CUDA tensors. Same contract as `soc_sweep_plain`."""
    if cand_all.device.type == "cpu":
        return soc_sweep_plain(cand_all, n, min_score, K)
    S, B, seven = cand_all.shape
    kernels.check(cand_all, "cand_all", torch.int32, (S, B, 7))
    kernels.check(n, "n", torch.int32, (B,))
    kernels.check(min_score, "min_score", torch.int32, (B,))
    # the kernel keeps each read's [K, 8] stack in shared memory
    if kernels.query("ma_soc_sweep_smem_bytes", K) < 0:
        raise ValueError(f"soc_sweep: K={K} stack slots do not fit in a block's shared memory")
    dev = cand_all.device
    stack = torch.empty((B, K, 8), dtype=torch.int32, device=dev)
    sp = torch.empty(B, dtype=torch.int32, device=dev)
    over = torch.empty(B, dtype=torch.uint8, device=dev)
    if B:
        kernels.SOC_SWEEP.launch(cand_all, n, min_score, stack, sp, over, S, B, K)
    return stack, sp, over.bool()
