"""The greedy LZ-parse automaton as a JAX state machine.

One (reference, query) pair is a sequential dependency chain
(factor choice at position i depends on all earlier factors), so the device
engine parallelizes *across pairs*: this module defines ``parse_one`` for a
single pair, and the engine vmaps it over query batches with
``axis_name=LANES`` (see ``batch_parser``). All control flow is
lax.while_loop with static shapes; the factor list lives in a fixed
int32[Fmax+1, 4] stack whose last row is a write-discard slot so that
conditional pushes are O(1) scatters.

Under vmap, a lax.cond with a per-lane predicate runs both branches and
selects, and a while_loop with a per-lane predicate selects between the old
and the new carry at every iteration. On the factor stack either costs a
copy of the whole stack (B x Lq x 16 bytes) per step. So nothing that
carries the stack branches: every push, amend and pop takes a per-lane
mask, and loops that carry the stack are ``_lane_loop``s, whose predicate
is "any lane still running" (a psum over LANES, the same for every lane)
and whose body leaves a finished lane unchanged. Every loop also takes a
``go`` guard, the conjunction of the predicates around it for this lane, so
that a lane stops at once in a branch it did not take. Masks and guards
are true wherever the unbatched program runs the code, so they change no
result.

Semantics are branch-for-branch those of the reference parser
(reference src/parser.cpp:482-716; sub-passes cited inline), validated
bit-exactly against the native oracle in tests/test_jax_engine.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

F_LIT, F_CLOSE, F_DISTANT = 0, 1, 2

I32 = jnp.int32
LANES = "lanes"  # the vmap axis of a batch of pairs


@dataclass(frozen=True)
class ParseCfg:
    mal: int = 11
    msl: int = 7
    mrd: int = 40
    mqd: int = 40
    reg: int = 35
    aw: int = 15
    am: int = 7
    ar: int = 3

    @classmethod
    def from_params(cls, p) -> "ParseCfg":
        return cls(p.min_anchor_len, p.min_seed_len, p.max_dist_in_ref,
                   p.max_dist_in_query, p.min_region_len, p.approx_window,
                   p.approx_mismatches, p.approx_run_len)


def _mix64(x):
    x = x.astype(jnp.uint64)
    x ^= x >> 33
    x *= jnp.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> 33
    x *= jnp.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> 33
    return x


def _prob_len(length):
    """4^-len as an exact f64 (parser.h:134-172: the table entries are
    exact powers of two), built from its bit pattern so that no backend's
    exp2 can round it. 1-4^-len rounds to 1.0 for len >= 27, so clamping
    the exponent keeps it in the normal range without changing a result."""
    e = jnp.clip(length, 0, 200).astype(jnp.uint64)
    return jax.lax.bitcast_convert_type((jnp.uint64(1023) - 2 * e) << 52,
                                        jnp.float64)


def _fpow(base, e, go):
    """Binary exponentiation with the reference's multiplication order
    (parser.h:174-188). e is uint32; the loop runs only where go."""
    e = jnp.where(go, e, jnp.uint32(0))

    def body(c):
        r, b, e = c
        r = jnp.where((e & 1) == 1, r * b, r)
        return r, b * b, e // 2

    r, _, _ = jax.lax.while_loop(lambda c: c[2] > 0, body,
                                 (jnp.float64(1.0), base, e))
    return r


def _lane_loop(cond, body, init):
    """while_loop over a batch of lanes: runs while any lane's cond holds;
    body(carry, active) must leave the carry of an inactive lane as it
    was. Unlike a vmapped while_loop, it selects nothing per iteration."""
    return jax.lax.while_loop(
        lambda c: jax.lax.psum(cond(c).astype(I32), LANES) > 0,
        lambda c: body(c, cond(c)), init)


def _lane_cond(pred, on_any, on_none, operand):
    """lax.cond over a batch of lanes: on_any when any lane's pred holds,
    else on_none (the same branch for every lane, so it is a real branch,
    not a select). on_any must give what on_none gives where pred is
    false."""
    return jax.lax.cond(jax.lax.psum(pred.astype(I32), LANES) > 0, on_any,
                        on_none, operand)


def _keep(m, new, old):
    return jax.tree_util.tree_map(lambda a, b: jnp.where(m, a, b), new, old)


def make_pair_parser(cfg: ParseCfg, Lr: int, Lq: int, table_size: int):
    """Returns parse_one(ref_ctx, query_ctx) -> (stats[3], fac, fp), to be
    called under vmap with axis_name=LANES.

    ref_ctx = (refbuf u8[Lr], ref_true i32, tab i32[T], tmask u64,
               bucket_pos i32[Lr], bucket_lo i32[4^msl], bucket_cnt i32[4^msl])
    query_ctx = (qbuf u8[Lq], q_true i32, q_seeds i64[Lq], q_anchors i64[Lq])
    """
    mal, msl, mrd, mqd = cfg.mal, cfg.msl, cfg.mrd, cfg.mqd
    reg, aw, am, ar = cfg.reg, cfg.aw, cfg.am, cfg.ar
    Fmax = Lq + 4  # every factor covers >= 1 query position

    def parse_one(refbuf, ref_true, tab, tmask, bucket_pos, bucket_lo,
                  bucket_cnt, qbuf, q_true, q_seeds, q_anchors):
        ref_true = ref_true.astype(I32)
        q_true = q_true.astype(I32)

        def combine_synced(s_len, s_pos, a_len, a_pos, lit_run, go):
            """Anchor-vs-close-seed arbitration (parser.cpp:604-623); an
            anchor at reference position 0 is ignored, and a seed result at
            position 0 counts as absent."""
            g = go & (a_pos != 0) & (s_pos != 0)
            pa = _fpow(1.0 - _prob_len(a_len),
                       (2 * (ref_true.astype(jnp.int64) + 1 - a_len))
                       .astype(jnp.uint32), g)
            pc = _fpow(1.0 - _prob_len(s_len),
                       (lit_run + mrd + 1 - s_len).astype(jnp.uint32), g)
            take_a = (a_pos != 0) & ((s_pos == 0) | (pa > pc))
            return (jnp.where(take_a, a_len, s_len),
                    jnp.where(take_a, a_pos, s_pos))

        # -- primitives ----------------------------------------------------
        def equal_len(rpos, dpos, start, go):
            """parser.cpp:192-207"""
            cap = jnp.where(go, jnp.minimum(ref_true - rpos, q_true - dpos),
                            start)

            def cond(r):
                return (r < cap) & (refbuf[rpos + r] == qbuf[dpos + r])

            return jax.lax.while_loop(cond, lambda r: r + 1, start)

        def anchor_search(i, go):
            """Walk the whole probe cluster; longest wins, first-seen wins
            ties (parser.cpp:514-531)."""
            km = q_anchors[i]
            go = go & (km >= 0)

            def walk(c):
                h, blen, bpos = c
                entry = tab[h.astype(I32)]
                ml = equal_len(entry, i, I32(0), go & (entry != -1))
                take = (ml >= mal) & (ml > blen)
                blen = jnp.where(take, ml, blen)
                bpos = jnp.where(take, entry, bpos)
                return (h + 1) & tmask, blen, bpos

            h0 = _mix64(km) & tmask
            _, blen, bpos = jax.lax.while_loop(
                lambda c: go & (tab[c[0].astype(I32)] != -1), walk,
                (h0, I32(0), I32(0)))
            return blen, bpos

        def seed_search(i, pred, lit_run, go):
            """Bucket scan within [pred-lit_run, pred+mrd): longest wins,
            nearest-to-prediction wins ties (parser.cpp:548-580)."""
            sd = q_seeds[i]
            go = go & (sd >= 0)
            lo = bucket_lo[sd]
            n = bucket_cnt[sd]
            target = pred - lit_run

            def bs(c):
                a, b = c
                mid = (a + b) // 2
                below = bucket_pos[lo + mid] < target
                return jnp.where(below, mid + 1, a), jnp.where(below, b, mid)

            j0, _ = jax.lax.while_loop(lambda c: go & (c[0] < c[1]), bs,
                                       (I32(0), n))

            def cond(c):
                j = c[0]
                return go & (j < n) & (bucket_pos[lo + j] < pred + mrd)

            def walk(c):
                j, blen, bpos = c
                pos = bucket_pos[lo + j]
                ml = equal_len(pos, i, I32(msl), cond(c))
                closer = jnp.abs(pos - pred) < jnp.abs(bpos - pred)
                take_new = ml > blen
                tie_swap = (ml == blen) & closer
                bpos = jnp.where(take_new | tie_swap, pos, bpos)
                blen = jnp.where(take_new, ml, blen)
                return j + 1, blen, bpos

            _, blen, bpos = jax.lax.while_loop(cond, walk,
                                               (j0, I32(0), I32(0)))
            return blen, bpos

        # -- factor stack --------------------------------------------------
        def push(fac, fp, dpos, kind, rpos, length, do):
            idx = jnp.where(do, fp, I32(Fmax))  # row Fmax = discard slot
            fac = fac.at[idx].set(
                jnp.stack([dpos, kind, rpos, length]).astype(I32))
            return fac, fp + do.astype(I32)

        def amend_len(fac, fp, delta, do):
            idx = jnp.where(do, fp - 1, I32(Fmax))
            fac = fac.at[idx, 3].add(delta.astype(I32))
            return fac

        def kind_of(j):
            return jnp.where(j, I32(F_CLOSE), I32(F_LIT))

        # -- aligned-range emission (parser.cpp:210-248) --------------------
        def emit_aligned(fac, fp, dpos, rpos, length, backward, go):
            length = jnp.where(go, length, I32(0))  # length 0 is a no-op
            flag0 = jnp.where(backward, I32(F_DISTANT), I32(F_CLOSE))

            def body(c, act):
                j, fac, fp, run, matching, flag = c
                eq = refbuf[rpos + j] == qbuf[dpos + j]
                # eq & matching: run+1
                # eq & !matching: push LIT(run) if run; run=1, matching=1
                # !eq & matching: push flag(run); run=1, matching=0, flag=CLOSE
                # !eq & !matching: run+1
                push_lit = act & eq & ~matching & (run > 0)
                fac, fp = push(fac, fp, dpos + j - run, I32(F_LIT), I32(0),
                               run, push_lit)
                push_m = act & ~eq & matching
                fac, fp = push(fac, fp, dpos + j - run, flag, rpos + j - run,
                               run, push_m)
                new = (j + 1, jnp.where(eq == matching, run + 1, I32(1)), eq,
                       jnp.where(push_m, I32(F_CLOSE), flag))
                j, run, matching, flag = _keep(act, new,
                                               (j, run, matching, flag))
                return j, fac, fp, run, matching, flag

            _, fac, fp, run, matching, flag = _lane_loop(
                lambda c: c[0] < length, body,
                (I32(0), fac, fp, I32(0), jnp.bool_(False), flag0))
            fac, fp = push(fac, fp, dpos + length - run, flag,
                           rpos + length - run, run, (length > 0) & matching)
            fac, fp = push(fac, fp, dpos + length - run, I32(F_LIT), I32(0),
                           run, (length > 0) & ~matching & (run > 0))
            return fac, fp

        # -- two-sided gap alignment (parser.cpp:251-374) -------------------
        def emit_gap(fac, fp, dpos, r_left, r_right, length, go):
            length = jnp.where(go, length, I32(0))  # length 0 is a no-op
            to_scan = jnp.where(r_right < r_left, length,
                                jnp.minimum(r_right - r_left, length))

            lhs_nm = jnp.zeros(mqd + 2, I32)
            lhs_eq = jnp.zeros(mqd + 2, jnp.bool_)

            def lbody(j, c):
                nm_arr, eq_arr, nm = c
                eq = refbuf[r_left + j] == qbuf[dpos + j]
                nm = nm + eq.astype(I32)
                return nm_arr.at[j + 1].set(nm), eq_arr.at[j + 1].set(eq), nm

            lhs_nm, lhs_eq, _ = jax.lax.fori_loop(
                0, to_scan, lbody, (lhs_nm, lhs_eq, I32(0)))

            rhs_nm = jnp.zeros(mqd + 2, I32)
            rhs_eq = jnp.zeros(mqd + 2, jnp.bool_)
            r_lim = jnp.minimum(to_scan, r_right)

            def rbody(j, c):
                nm_arr, eq_arr, nm = c
                eq = refbuf[r_right - j] == qbuf[dpos + length - j]
                nm = nm + eq.astype(I32)
                return nm_arr.at[j].set(nm), eq_arr.at[j].set(eq), nm

            # j runs 1..r_lim (fori is half-open, so 1..r_lim+1)
            rhs_nm, rhs_eq, _ = jax.lax.fori_loop(
                1, r_lim + 1, rbody, (rhs_nm, rhs_eq, I32(0)))

            def sbody(j, c):
                best, split = c
                tot = lhs_nm[j] + rhs_nm[to_scan - j]
                upd = tot >= best  # >= : rightmost split wins ties
                return jnp.where(upd, tot, best), jnp.where(upd, j, split)

            _, split = jax.lax.fori_loop(0, to_scan + 1, sbody,
                                         (I32(0), I32(0)))

            # --- store left (where split > 0)
            eq1 = lhs_eq[1]
            fac, fp = push(fac, fp, dpos, kind_of(eq1),
                           jnp.where(eq1, r_left, I32(0)), I32(1), split > 0)

            def lstore(c, act):
                j, fac, fp = c
                eq = lhs_eq[j]
                merge = kind_of(eq) == fac[fp - 1, 1]
                fac = amend_len(fac, fp, I32(1), act & merge)
                fac, fp = push(fac, fp, dpos + j - 1, kind_of(eq),
                               jnp.where(eq, r_left + j - 1, I32(0)),
                               I32(1), act & ~merge)
                return jnp.where(act, j + 1, j), fac, fp

            _, fac, fp = _lane_loop(lambda c: c[0] < split + 1, lstore,
                                    (I32(2), fac, fp))

            # --- store middle (where to_scan < length)
            mid = to_scan < length
            merge = mid & (split > 0) & (fac[fp - 1, 1] == F_LIT)
            fac = amend_len(fac, fp, length - to_scan, merge)
            fac, fp = push(fac, fp, dpos + split, I32(F_LIT), I32(0),
                           length - to_scan, mid & ~merge)

            # --- store right (where split < to_scan)
            right = split < to_scan
            shift = length - to_scan
            from_right = to_scan - split
            eq = rhs_eq[from_right]
            dp0 = dpos + split + shift
            merge = (~eq & ((split > 0) | (shift > 0))
                     & (fac[fp - 1, 1] == F_LIT))
            fac = amend_len(fac, fp, I32(1), right & merge)
            fac, fp = push(fac, fp, dp0, kind_of(eq),
                           jnp.where(eq, r_right - from_right, I32(0)),
                           I32(1), right & ~merge)
            # NOTE: when merged, the data cursor is NOT advanced
            # (reference parser.cpp:355-358)
            dp = jnp.where(merge, dp0, dp0 + 1)

            def rstore(c, act):
                j, dp, fac, fp = c
                eq = rhs_eq[j]
                merge = kind_of(eq) == fac[fp - 1, 1]
                fac = amend_len(fac, fp, I32(1), act & merge)
                fac, fp = push(fac, fp, dp, kind_of(eq),
                               jnp.where(eq, r_right - j, I32(0)),
                               I32(1), act & ~merge)
                return (jnp.where(act, j - 1, j), jnp.where(act, dp + 1, dp),
                        fac, fp)

            _, _, fac, fp = _lane_loop(lambda c: right & (c[0] > 0), rstore,
                                       (from_right - 1, dp, fac, fp))
            return fac, fp

        # -- approximate extensions (parser.cpp:377-441) --------------------
        def extend(dpos, rpos, max_len, forward, go):
            win = jnp.zeros(aw, I32)

            def body(c):
                e, bad, run, last, win = c
                d = jnp.where(forward, dpos + e, dpos - e - 1)
                r = jnp.where(forward, rpos + e, rpos - e - 1)
                miss = (qbuf[d] != refbuf[r]).astype(I32)
                bad = bad - win[e % aw] + miss
                win = win.at[e % aw].set(miss)
                run = jnp.where(miss == 0, run + 1, I32(0))
                last = jnp.where((miss == 0) & (run >= ar), e + 1, last)
                stop = bad > am
                return jnp.where(stop, -e - 1, e + 1), bad, run, last, win

            def cond(c):
                e = c[0]
                in_range = jnp.where(
                    forward,
                    (dpos + e < q_true) & (rpos + e < ref_true),
                    (dpos - e > 0) & (rpos - e > 0) & (e < max_len))
                return go & (e >= 0) & in_range

            _, _, _, last, _ = jax.lax.while_loop(
                cond, body, (I32(0), I32(0), I32(ar), I32(0), win))
            return last

        # -- the main automaton (parser.cpp:482-716) ------------------------
        def distant(fac, fp, i, lit_run, reg_lo, reg_hi, best_pos, best_len,
                    go):
            """The distant-match branch (parser.cpp:638-684), where go."""
            fac, fp = push(fac, fp, i - lit_run, I32(F_LIT), I32(0),
                           lit_run, go & (lit_run > 0))

            # region kill (parser.cpp:643-657): pop the region's factors,
            # then the literals before it, and push one literal for all
            do_kill = (reg_lo >= 0) & (reg_hi - reg_lo < reg)
            go_kill = go & do_kill
            fp = jax.lax.while_loop(
                lambda f: go_kill & (f > 0) & (fac[f - 1, 0] >= reg_lo),
                lambda f: f - 1, fp)

            def pop_lit(c):
                f, run_len = c
                return f - 1, run_len + fac[f - 1, 3]

            fp, run_len = jax.lax.while_loop(
                lambda c: go_kill & (c[0] > 0) & (fac[c[0] - 1, 1] == F_LIT),
                pop_lit, (fp, i - reg_lo))
            fac, fp = push(fac, fp, i - run_len, I32(F_LIT), I32(0), run_len,
                           go_kill)
            reg_lo = jnp.where(do_kill, I32(-1), reg_lo)

            # backward extension into the trailing literal run
            tail_lit = (fp > 0) & (fac[fp - 1, 1] == F_LIT)
            bwd = extend(i, best_pos, fac[fp - 1, 3], jnp.bool_(False),
                         go & tail_lit)
            use_bwd = tail_lit & (bwd > 0)
            go_bwd = go & use_bwd
            fac = amend_len(fac, fp, -bwd, go_bwd)
            fp = jnp.where(go_bwd & (fac[fp - 1, 3] == 0), fp - 1, fp)
            fac, fp = emit_aligned(fac, fp, i - bwd, best_pos - bwd, bwd,
                                   jnp.bool_(True), go_bwd)
            flag = jnp.where(use_bwd, I32(F_CLOSE), I32(F_DISTANT))
            reg_lo = jnp.where(use_bwd, i - bwd, reg_lo)

            fac, fp = push(fac, fp, i, flag, best_pos, best_len, go)
            reg_lo = jnp.where(flag == F_DISTANT, i, reg_lo)

            # rescan for the last distant match (parser.cpp:678-684)
            go_scan = go & (reg_lo < 0)

            def rb(c):
                j, found = c
                hit = fac[j, 1] == F_DISTANT
                return (jnp.where(hit, I32(-1), j - 1),
                        jnp.where(hit, fac[j, 0], found))

            _, found = jax.lax.while_loop(
                lambda c: go_scan & (c[0] >= 0), rb, (fp - 1, I32(-1)))
            reg_lo = jnp.where(reg_lo < 0, found, reg_lo)
            return fac, fp, reg_lo

        def step(st, live):
            i, pred, lit_run, reg_lo, reg_hi, fac, fp = st

            # Each stage below is skipped outright when no lane needs it
            # (_lane_cond): a desynced literal step runs the anchor probe
            # alone.
            synced = pred >= 0
            a_len, a_pos = anchor_search(i, live)
            go_seed = live & synced

            def with_seed(_):
                s_len, s_pos = seed_search(i, pred, lit_run, go_seed)
                c_len, c_pos = combine_synced(s_len, s_pos, a_len, a_pos,
                                              lit_run, go_seed)
                return (jnp.where(synced, c_len, a_len),
                        jnp.where(synced, c_pos, a_pos))

            best_len, best_pos = _lane_cond(go_seed, with_seed,
                                            lambda _: (a_len, a_pos), None)
            matched = live & (best_len >= msl)
            close = synced & (jnp.abs(best_pos - pred) <= mrd)

            # close match (parser.cpp:624-637)
            go_close = matched & close

            def close_match(c):
                fac, fp = c
                fac, fp = emit_gap(fac, fp, i - lit_run, pred - lit_run,
                                   best_pos + best_len, lit_run, go_close)
                return push(fac, fp, i, I32(F_CLOSE), best_pos, best_len,
                            go_close)

            fac, fp = _lane_cond(go_close, close_match, lambda c: c,
                                 (fac, fp))
            # distant match
            go_dist = matched & ~close
            fac, fp, reg_lo_d = _lane_cond(
                go_dist,
                lambda c: distant(c[0], c[1], i, lit_run, c[2], reg_hi,
                                  best_pos, best_len, go_dist),
                lambda c: c, (fac, fp, reg_lo))

            # forward extension after any match (parser.cpp:686-700)
            i_m = i + best_len
            pred_m = best_pos + best_len

            def forward(c):
                fac, fp = c
                ext = extend(i_m, pred_m, I32(0), jnp.bool_(True), matched)
                fac, fp = emit_aligned(fac, fp, i_m, pred_m, ext,
                                       jnp.bool_(False), matched)
                return fac, fp, ext

            fac, fp, ext = _lane_cond(matched, forward,
                                      lambda c: (*c, I32(0)), (fac, fp))

            new = (jnp.where(matched, i_m + ext, i + 1),
                   jnp.where(matched, pred_m + ext, pred + 1),
                   jnp.where(matched, I32(0), lit_run + 1),
                   jnp.where(go_dist, reg_lo_d, reg_lo),
                   jnp.where(matched, i_m + ext, reg_hi))
            i2, pred2, lit2, reg_lo2, reg_hi2 = new
            pred2 = jnp.where(lit2 > mqd, -q_true, pred2)  # desync (:706)
            small = _keep(live, (i2, pred2, lit2, reg_lo2, reg_hi2),
                          (i, pred, lit_run, reg_lo, reg_hi))
            return (*small, fac, fp)

        fac0 = jnp.zeros((Fmax + 1, 4), I32)
        init = (I32(0), -q_true, I32(0), I32(-1), I32(0), fac0, I32(0))
        i, pred, lit_run, _, _, fac, fp = _lane_loop(
            lambda st: st[0] + msl < q_true, step, init)

        # tail (parser.cpp:710-713)
        unsynced = pred < 0
        fac, fp = push(fac, fp, i - lit_run, I32(F_LIT), I32(0),
                       lit_run + (q_true - i), unsynced)
        fac, fp = emit_aligned(fac, fp, i - lit_run, pred - lit_run - msl,
                               lit_run + (q_true - i), jnp.bool_(False),
                               ~unsynced)

        stats = _component_stats(fac, fp, reg)
        return stats, fac, fp

    return parse_one


def batch_parser(cfg: ParseCfg, Lr: int, Lq: int, table_size: int,
                 want_factors: bool = False):
    """parse_one vmapped over a batch of queries against one reference:
    f(ref_ctx..., qbufs u8[B, Lq], q_trues i32[B], q_seeds, q_anchors) ->
    stats i32[B, 3] (and fac, fp when want_factors)."""
    parse_one = make_pair_parser(cfg, Lr, Lq, table_size)

    def run(refbuf, ref_true, tab, tmask, bucket_pos, bucket_lo, bucket_cnt,
            qbufs, q_trues, q_seeds, q_anchors):
        def one(qbuf, q_true, seeds, anchors):
            stats, fac, fp = parse_one(refbuf, ref_true, tab, tmask,
                                       bucket_pos, bucket_lo, bucket_cnt,
                                       qbuf, q_true, seeds, anchors)
            return (stats, fac, fp) if want_factors else stats

        return jax.vmap(one, axis_name=LANES)(qbufs, q_trues, q_seeds,
                                              q_anchors)

    return run


def _component_stats(fac, fp, reg):
    """Fold the factor list into (sym_in_matches, sym_in_literals,
    components) — parser.cpp:734-783."""

    def body(j, c):
        tm, tl, nc, cm, cl, pend = c
        kind = fac[j, 1]
        ln = fac[j, 3]
        is_d = kind == F_DISTANT
        is_c = kind == F_CLOSE
        keep = is_d & (cm > 0) & (cm + cl >= reg)
        tm = jnp.where(keep, tm + cm, tm)
        tl = jnp.where(keep, tl + cl, tl)
        nc = jnp.where(keep, nc + 1, nc)
        cm = jnp.where(is_d, ln, jnp.where(is_c, cm + ln, cm))
        cl = jnp.where(is_d, I32(0), jnp.where(is_c, cl + pend, cl))
        pend = jnp.where(is_d, I32(0),
                         jnp.where(is_c, I32(0), pend + ln))
        return tm, tl, nc, cm, cl, pend

    tm, tl, nc, cm, cl, _ = jax.lax.fori_loop(
        0, fp, body, (I32(0),) * 6)
    keep = (cm > 0) & (cm + cl >= reg)
    tm = jnp.where(keep, tm + cm, tm)
    tl = jnp.where(keep, tl + cl, tl)
    nc = jnp.where(keep, nc + 1, nc)
    return jnp.stack([tm, tl, nc])
