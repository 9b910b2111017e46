"""RNN-T greedy search, plain and hotword-gated (port of
``wenet_celoss_tpu/decode/rnnt_greedy.py``: ``rnnt_greedy_search_labelsync``,
``rnnt_gated_greedy_search_labelsync``, ``rnnt_gated_greedy_search_exact``,
``rnnt_greedy_chunk`` and ``greedy_to_lists``). The "exact" search and the
serving worker's ``rnnt_greedy_chunk`` are frame-by-frame host loops; the
other two are label-synchronous.

Between emissions the predictor state does not change, so one joint of
EVERY frame against the current predictor state finds each row's next
non-blank frame at once: the loop runs once per emitted label (plus one),
not once per frame and emission step. Each row emits at most ``n_steps``
tokens on one frame, then moves past it, as the frame-synchronous search
does. The loop is a Python ``while`` with one host sync per iteration.

``trace``, when a list is passed, receives per iteration a [B] tensor: the
smallest top-1 minus top-2 logit gap (joint logits, and the hotword-gate
logits where gating) over the frames that iteration's choice depended on.
A second run whose sums are taken in another order can flip an argmax
only where that gap is close to 0.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _labelsync_loop(predictor_step: Callable, frame_logits: Callable,
                    init_state, t_max: int, encoder_lens: torch.Tensor,
                    blank: int, n_steps: int, u_max: int,
                    gate_all: Optional[torch.Tensor] = None,
                    gate_gap: Optional[torch.Tensor] = None,
                    trace: Optional[list] = None):
    """The shared search loop. ``frame_logits(pred_out)`` → joint logits
    [B, T, V] of every frame against the current predictor output."""
    b = encoder_lens.shape[0]
    dev = encoder_lens.device
    if u_max <= 0:
        u_max = n_steps * t_max
    pred_out, state = predictor_step(
        torch.full((b,), blank, dtype=torch.long, device=dev), init_state,
        torch.zeros((b,), dtype=torch.long, device=dev))
    buf = torch.zeros((b, u_max), dtype=torch.long, device=dev)
    gate_buf = torch.zeros_like(buf)
    cnt = torch.zeros((b,), dtype=torch.long, device=dev)
    t_ptr = torch.zeros_like(cnt)   # next frame to (re)consider
    k = torch.zeros_like(cnt)       # emissions already at t_ptr
    done = encoder_lens <= 0
    fidx = torch.arange(t_max, device=dev)[None, :]
    pos_rows = torch.arange(b, device=dev)
    it = 0
    while it <= u_max and not bool(done.all()):
        logits = frame_logits(pred_out)                          # [B, T, V]
        toks_all = torch.argmax(logits, dim=-1)
        in_range = (fidx >= t_ptr[:, None]) & (fidx < encoder_lens[:, None])
        elig = in_range & (toks_all != blank)
        has = elig.any(dim=1)
        do = has & ~done & (cnt < u_max)
        f = torch.argmax(elig.to(torch.int32), dim=1)            # first hit
        tok = torch.gather(toks_all, 1, f[:, None])[:, 0]
        tok = torch.where(do, tok, torch.full_like(tok, blank))
        if trace is not None:
            seen = in_range & ((fidx <= f[:, None]) | ~has[:, None])
            gap = _top2_gap(logits)
            if gate_gap is not None:
                gap = torch.minimum(gap, gate_gap)
            trace.append(torch.where(seen, gap, torch.inf).amin(dim=1))

        pos = torch.clamp(cnt, max=u_max - 1)
        buf[pos_rows, pos] = torch.where(do, tok, buf[pos_rows, pos])
        if gate_all is not None:
            gate = torch.gather(gate_all, 1, f[:, None])[:, 0]
            gate_buf[pos_rows, pos] = torch.where(do, gate,
                                                  gate_buf[pos_rows, pos])
        cnt = cnt + do.long()

        # Per-frame emission budget: landing on the same frame increments
        # k; a fresh frame restarts it at 1; hitting n_steps moves past.
        k_new = torch.where(f == t_ptr, k + 1, torch.ones_like(k))
        exhaust = k_new >= n_steps
        t_ptr = torch.where(do, torch.where(exhaust, f + 1, f), t_ptr)
        k = torch.where(do, torch.where(exhaust, torch.zeros_like(k), k_new),
                        k)
        done = done | ~do

        new_pred, state = predictor_step(tok, state, (~do).long())
        keep = do[:, None].to(pred_out.dtype)
        pred_out = new_pred * keep + pred_out * (1 - keep)
        it += 1
    return buf, cnt, gate_buf


def rnnt_greedy_search_labelsync(predictor_step: Callable,
                                 joint_frames: Callable, init_state,
                                 t_max: int, encoder_lens: torch.Tensor,
                                 blank: int = 0, n_steps: int = 4,
                                 u_max: int = 0,
                                 trace: Optional[list] = None):
    """Plain greedy decode.

    Args:
      predictor_step: (token [B], state, padding [B]) → (pred_out [B, P],
        state); padding 1 freezes that row's state.
      joint_frames: (pred_out [B, P]) → joint logits [B, T, V] of every
        encoder frame against this predictor output.
      t_max: number of encoder frames.
    Returns: (tokens [B, U_cap], lens [B]).
    """
    buf, cnt, _ = _labelsync_loop(predictor_step, joint_frames, init_state,
                                  t_max, encoder_lens, blank, n_steps, u_max,
                                  trace=trace)
    return buf, cnt


def rnnt_gated_greedy_search_labelsync(
        predictor_step: Callable, predictor_bias_step: Callable,
        joint_frames_sel: Callable, gate_logits: torch.Tensor, init_state,
        t_max: int, encoder_lens: torch.Tensor, blank: int = 0,
        n_steps: int = 4, u_max: int = 0, gate_on: bool = True,
        predictor_bias_step_empty: Optional[Callable] = None,
        trace: Optional[list] = None):
    """Hotword-gated greedy decode.

    Decode-time gating does not depend on the predictor (the gate attends
    a singleton key), so the [B, T] gate map comes in up front and only
    the per-frame choice of predictor stream stays inside the loop.

    Args:
      predictor_bias_step: (pred_out) → (biased pred [B, P], branch).
      predictor_bias_step_empty: the same over the empty (sentinel-only)
        hotword list; identity when None.
      joint_frames_sel: (pred_biased, pred_empty, use_bias [B, T] bool) →
        joint logits [B, T, V] of every gate-selected encoder frame against
        the gate-selected predictor stream.
      gate_logits: [B, T, num_labels]; the gate of a frame is its argmax.
      gate_on: False decodes purely on the biased streams.
    Returns: (tokens [B, U_cap], lens [B], gates [B, U_cap]).
    """
    if predictor_bias_step_empty is None:
        predictor_bias_step_empty = lambda p: (p, p)
    gate_all = torch.argmax(gate_logits, dim=-1)
    use_bias_all = (gate_all > 0) if gate_on else \
        torch.ones_like(gate_all, dtype=torch.bool)

    def frame_logits(pred_out):
        pred_biased, _ = predictor_bias_step(pred_out)
        pred_empty, _ = predictor_bias_step_empty(pred_out)
        return joint_frames_sel(pred_biased, pred_empty, use_bias_all)

    gate_gap = None
    if trace is not None and gate_on:
        gate_gap = _top2_gap(gate_logits)
    return _labelsync_loop(predictor_step, frame_logits, init_state, t_max,
                           encoder_lens, blank, n_steps, u_max,
                           gate_all=gate_all, gate_gap=gate_gap, trace=trace)


def rnnt_gated_greedy_search_exact(predictor_step: Callable,
                                   predictor_bias_step: Callable,
                                   predictor_bias_step_empty: Callable,
                                   joint_step: Callable, gate_step: Callable,
                                   init_state, encoder_out_empty,
                                   encoder_out_biased, enc_bias,
                                   encoder_len: int, blank: int = 0,
                                   n_steps: int = 4, loss_mode: str = "pred",
                                   trace: Optional[list] = None):
    """The hotword-gated greedy decode with backtracking repair, one
    utterance per call (batch 1 throughout), line for line with the JAX
    package's function of the same name.

    - Streams: under ``loss_mode`` "pred" a gate of 1 pairs the
      real-list-biased encoder with the EMPTY-list-biased predictor and a
      gate of 0 the other way round; under any other mode the streams stay
      aligned (gate 1: both real-biased, gate 0: both empty-biased).
    - Backtrack: when a gate-1 step follows a gate-0 step, the gate-0
      step's token (if any), its record and its predictor input and state
      are dropped, the loop rewinds to that step's frame (``last_t``) and
      replays with the gate forced to 1 until it passes the frame where
      the 1 appeared (``go_back_end``). ``per_frame_noblk`` may go
      negative there, as in the JAX package.
    - The gate record holds one entry per predictor step, not per token.

    A host loop: each step reads its gate and token to the host. The
    step callables must return new tensors: a state saved in
    ``cache_list`` is restored several steps later. Returns (hyps, gates)
    as Python lists.

    ``trace``, when a list is passed, receives one (gate, token, gap) per
    decision: the gate read (-1 where none was), the token (-1 where the
    gate started a backtrack and no joint ran) and the smallest top-1
    minus top-2 gap of the logits read (gate and joint).
    """
    dev = encoder_out_biased.device
    t = 0
    hyps: list = []
    result: list = []
    prev_out_nblk = True
    per_frame_noblk = 0
    go_back_flag = 0
    go_back_end = -1
    last_t = 0
    cache = init_state
    pred_input = torch.full((1,), blank, dtype=torch.long, device=dev)
    no_pad = torch.zeros((1,), dtype=torch.long, device=dev)
    cache_list: list = []
    input_list: list = []
    pred_sel = new_cache = None

    while t < encoder_len:
        step_gate, step_gap = -1, float("inf")
        enc_t_empty = encoder_out_empty[:, t]
        enc_t_biased = encoder_out_biased[:, t]
        bias_t = enc_bias[:, t]
        if prev_out_nblk:
            pred_out_step, new_cache = predictor_step(pred_input, cache,
                                                      no_pad)
            cache_list.append(cache)
            input_list.append(pred_input)
            _, pred_bias_branch = predictor_bias_step(pred_out_step)
            gate_logits = gate_step(bias_t, pred_bias_branch)
            gate = int(torch.argmax(gate_logits, dim=-1)[0])
            if trace is not None:
                step_gate = gate
                step_gap = float(_top2_gap(gate_logits)[0])
            if go_back_flag == 0:
                if gate == 0:
                    result.append(0)
                    last_t = t
                else:
                    if result and result[-1] == 0:
                        if trace is not None:
                            trace.append((gate, -1, step_gap))
                        go_back_end = t
                        t = last_t
                        go_back_flag = 1
                        result.pop()
                        if hyps:
                            hyps.pop()
                        input_list.pop()
                        per_frame_noblk -= 1
                        cache_list.pop()
                        cache = cache_list[-1]
                        pred_input = input_list[-1]
                        continue
                    result.append(1)
            else:
                result.append(1)
                if t >= go_back_end:
                    go_back_flag = 0
            if loss_mode == "pred":
                if result[-1] == 1:
                    pred_sel, _ = predictor_bias_step_empty(pred_out_step)
                else:
                    pred_sel, _ = predictor_bias_step(pred_out_step)
            else:
                if result[-1] == 1:
                    pred_sel, _ = predictor_bias_step(pred_out_step)
                else:
                    pred_sel, _ = predictor_bias_step_empty(pred_out_step)

        enc_sel = enc_t_biased if result[-1] == 1 else enc_t_empty
        logits = joint_step(enc_sel, pred_sel)
        tok = int(torch.argmax(logits, dim=-1)[0])
        if trace is not None:
            trace.append((step_gate, tok,
                          min(step_gap, float(_top2_gap(logits)[0]))))
        if tok != blank:
            hyps.append(tok)
            prev_out_nblk = True
            per_frame_noblk += 1
            pred_input = torch.full((1,), tok, dtype=torch.long, device=dev)
            cache = new_cache
        if tok == blank or per_frame_noblk >= n_steps:
            if tok == blank:
                prev_out_nblk = False
            t += 1
            per_frame_noblk = 0
    return hyps, result


def rnnt_greedy_chunk(predictor_step: Callable, joint_step: Callable,
                      carry, encoder_chunk: torch.Tensor, blank: int = 0,
                      n_steps: int = 4):
    """Greedy-decode one encoder chunk [B, Tc, E], resuming from ``carry``
    = (pred_out [B, P], predictor state) → (tokens [B, Tc·n_steps], lens
    [B], new carry): the streaming building block of the serving worker.

    Frame by frame, up to ``n_steps`` emissions a frame, each as the JAX
    package orders it: the joint's argmax, then ``do = alive & tok !=
    blank & cnt < u_cap``, then the predictor step with padding ``~do``
    (the padding freezes a row's state), then pred_out kept where no token
    was emitted. A frame's loop stops once no row emits: the steps it
    skips would change nothing."""
    pred_out, state = carry
    b, t_c, _ = encoder_chunk.shape
    dev = encoder_chunk.device
    u_cap = t_c * n_steps
    buf = torch.zeros((b, u_cap), dtype=torch.long, device=dev)
    cnt = torch.zeros((b,), dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    for t in range(t_c):
        enc_t = encoder_chunk[:, t]
        alive = torch.ones((b,), dtype=torch.bool, device=dev)
        for _ in range(n_steps):
            tok = torch.argmax(joint_step(enc_t, pred_out), dim=-1)
            do = alive & (tok != blank) & (cnt < u_cap)
            if not bool(do.any()):
                break
            pos = torch.clamp(cnt, max=u_cap - 1)
            buf[rows, pos] = torch.where(do, tok, buf[rows, pos])
            cnt = cnt + do.long()
            new_pred, state = predictor_step(tok, state, (~do).long())
            keep = do[:, None].to(pred_out.dtype)
            pred_out = new_pred * keep + pred_out * (1 - keep)
            alive = do
    return buf, cnt, (pred_out, state)


def greedy_to_lists(tokens, lens) -> List[List[int]]:
    tokens = np.asarray(torch.as_tensor(tokens).cpu())
    lens = np.asarray(torch.as_tensor(lens).cpu())
    return [[int(x) for x in tokens[i, : lens[i]]]
            for i in range(tokens.shape[0])]
