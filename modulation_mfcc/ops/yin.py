"""pYIN fundamental-frequency estimation (probabilistic YIN), batched JAX.

Replaces the reference's ``librosa.pyin`` path (script/calc.py:562-581) with
the same published algorithm (Mauch & Dixon 2014, librosa's formulation):

  1. YIN difference function per frame via cumulative sums + sliding window
     products; cumulative-mean-normalized difference (CMNDF).
  2. Trough candidates = local minima of the CMNDF on the lag band, with
     librosa's band-edge rules; per-threshold trough selection on the RAW
     trough heights with a Beta(2,18) prior over thresholds and a Boltzmann
     prior over trough rank; ``no_trough_prob`` mass to the lowest trough
     for thresholds that no trough clears.
  3. Candidate periods refined by parabolic interpolation (librosa's
     ``|shift| > 1 → 0`` rule), probabilities scattered onto a log-spaced
     pitch-bin grid (``ceil(1/resolution)`` bins/semitone) with
     voiced+unvoiced state duplication.
  4. Viterbi decoding with librosa's ``transition_local`` triangular window
     (full length ``int(max_transition_rate·12·bins_per_semitone·hop/sr)``)
     kron'd with the voiced↔unvoiced ``switch_prob`` loop, and the initial
     distribution uniform over the UNVOICED states only.

The exact librosa quirks are preserved so the decoded pitch bins match the
float64 oracle (oracle.pyin_np) bit-for-bit on real signals:

  * the difference function is librosa's, not the textbook YIN one: the
    correlation term sums ``j = 0..win_length`` (win_length+1 products)
    while the energy terms sum ``j = τ+1..τ+win_length`` — and correlation
    and energy values with magnitude < 1e-6 are snapped to zero;
  * trough heights used for the threshold sweep are the raw CMNDF values
    (the parabolic refinement only adjusts the decoded period);
  * a candidate whose refined frequency rounds above the top pitch bin is
    dropped (librosa clips the bin index into the unvoiced block, whose
    rows are then overwritten).

Everything is static-shape: troughs are handled as masks over the full lag
band (no dynamic candidate lists), the Viterbi is a [S,S] max-plus relaxation
scanned over frames.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import scipy.stats

import jax
import jax.numpy as jnp

__all__ = ["pyin_f0", "yin_cmndf"]


def _cmndf_from_terms(cross, e_tau, dtype):
    """librosa CMNDF from the correlation/energy window sums.

    ``cross[..., τ] = Σ_{j=0}^{w} x[j]·x[j+τ]`` (w+1 products — librosa's
    off-by-one), ``e_tau[..., τ] = Σ_{j=τ+1}^{τ+w} x[j]²`` (w terms,
    shifted by one). Values with magnitude < 1e-6 are snapped to zero
    (librosa does this to the irfft output and the energy differences),
    then d(τ) = e(0) + e(τ) − 2·c(τ) and
    d'(τ) = d(τ) / (mean(d(1..τ)) + tiny). d'(0) is set to 1 (never read:
    the pyin band starts at min_period ≥ 1).
    """
    cross = jnp.where(jnp.abs(cross) < 1e-6, 0.0, cross)
    e_tau = jnp.where(jnp.abs(e_tau) < 1e-6, 0.0, e_tau)
    d = e_tau[..., :1] + e_tau - 2.0 * cross
    tau_f = jnp.arange(1, d.shape[-1], dtype=dtype)
    cum_mean = jnp.cumsum(d[..., 1:], axis=-1) / tau_f
    tiny = jnp.finfo(dtype).tiny
    cmndf = d[..., 1:] / (cum_mean + tiny)
    return jnp.concatenate([jnp.ones_like(d[..., :1]), cmndf], axis=-1)


def yin_cmndf(frames: jnp.ndarray, max_lag: int, win_length: int | None = None) -> jnp.ndarray:
    """librosa's cumulative-mean-normalized difference d'(τ), τ∈[0, max_lag].

    frames: [..., N]; ``win_length`` defaults to N − max_lag − 1 (so every
    index read stays inside the frame). Implements librosa's exact
    formulation — see :func:`_cmndf_from_terms` for the index quirks that
    make this differ (by O(1/w) relative) from the textbook difference
    function. FFT cross-correlation form (reference for the frameless
    sliding version below and for batch paths that already hold frames).
    """
    n = frames.shape[-1]
    w = n - max_lag - 1 if win_length is None else win_length
    if w + 1 + max_lag > n:
        raise ValueError("frames too short for win_length + max_lag + 1")
    # energy e(τ) = Σ_{j=τ+1}^{τ+w} x_j² via cumulative sums
    csum = jnp.cumsum(frames**2, axis=-1)
    total = jnp.concatenate([jnp.zeros_like(csum[..., :1]), csum], axis=-1)
    # consecutive indices -> contiguous slices, not gathers
    e_tau = jax.lax.slice_in_dim(total, w + 1, w + max_lag + 2, axis=-1) - jax.lax.slice_in_dim(
        total, 1, max_lag + 2, axis=-1
    )
    # cross terms Σ_{j=0}^{w} x_j·x_{j+τ} via rFFT cross-correlation of the
    # first w+1 samples against the whole frame. No aliasing as long as
    # nfft ≥ w + 1 + max_lag: every product index j+τ ≤ w + max_lag stays
    # inside one period, so the circular correlation equals the linear one
    # on the lags read below.
    nfft = int(2 ** np.ceil(np.log2(max(n, w + 1 + max_lag))))
    spec = jnp.fft.rfft(frames, n=nfft, axis=-1)
    specw = jnp.fft.rfft(frames[..., : w + 1], n=nfft, axis=-1)
    cross = jnp.fft.irfft(jnp.conj(specw) * spec, n=nfft, axis=-1)[..., : max_lag + 1]
    return _cmndf_from_terms(cross, e_tau, frames.dtype)


def _cmndf_nfft(m: int) -> int:
    """FFT size for the row correlations: the next power of two."""
    return int(2 ** np.ceil(np.log2(m)))


def _sliding_cmndf(
    xp: jnp.ndarray, nf: int, hop: int, w: int, max_lag: int,
    engine: str = "fft",
) -> jnp.ndarray:
    """librosa CMNDF d'(τ), τ∈[0, max_lag], for frames starting at f·hop,
    via ROW-LEVEL FFT correlations — no frame matrix, no per-τ loop.

    YIN's difference function is unwindowed, so every frame quantity is a
    plain window sum over a per-τ product series (librosa's index quirks,
    see _cmndf_from_terms):
        cross[f, τ] = Σ_{j=0}^{w} xp[s+j]·xp[s+j+τ],     s = f·hop
        e_tau[f, τ] = Σ_{j=1}^{w} xp[s+τ+j]²
    Frame starts are hop-aligned, so each window sum decomposes into whole
    hop-row sums plus one partial row (the rms_envelope trick). The row-
    level sums are themselves short correlations: with R[u,r] = xp[u·hop+r]
    and the local context C[u,m] = xp[u·hop+m] (m < hop+max_lag+1),
        P_τ[u]  = Σ_{r<hop} R[u,r]·C[u,r+τ]          (cross row term)
        Q_λ[u]  = Σ_{r<hop} C²[u,r+λ]                 (energy row term)
    i.e. one FFT cross-correlation of each non-overlapping hop-row against
    its short context — nfft = next_pow2(hop+max_lag+1) (256 at the 10 kHz
    defaults) instead of one 2048-pt FFT per overlapping frame, a ~26×
    FLOP cut with none of the per-τ kernel-launch overhead of the earlier
    sliding-sum loop. librosa itself computes the difference function by FFT autocorrelation, so FFT
    reduction order is faithful to the reference (script/calc.py:562-581).

    Equal to ``yin_cmndf(frame_by_slices(xp, 0, nf, w+max_lag+1, hop),
    max_lag, win_length=w)`` up to float reduction order.

    ``engine='matmul'`` computes the SAME row correlations with host-built
    real-DFT matmuls at HIGHEST precision instead of FFT kernels (the
    transform of ops/pitch.py _dft_mats): forward projections are
    one [rows, n_in]·[n_in, 2K] matmul each, the cross-spectrum is an
    elementwise complex product expressed on the real/imag planes, and the
    inverse transform is two [K, L] matmuls. Equal to the FFT engine up to
    float reduction order (the decoded pitch bins may differ on voicing-
    boundary frames; 'fft' stays the parity default — librosa itself is
    FFT-based).
    """
    q1, rem1 = divmod(w + 1, hop)  # cross windows are w+1 products long
    q2, rem2 = divmod(w, hop)  # energy windows are w products long
    n_rows = nf + q1  # last row read: f_max + q1 (partial), f_max = nf-1
    m_ctx = hop + max_lag + 1  # context: r < hop, lag ≤ max_lag+1
    nfft = _cmndf_nfft(max(m_ctx, 2))
    need_len = (n_rows - 1) * hop + m_ctx
    if xp.shape[-1] < need_len:
        cfgp = [(0, 0)] * (xp.ndim - 1) + [(0, need_len - xp.shape[-1])]
        xp = jnp.pad(xp, cfgp)

    # rows + shifted rows -> local context C[u, :m_ctx] (plain reshapes and
    # static sublane shifts; rows are NON-overlapping so no frame blowup)
    flat = jax.lax.slice_in_dim(xp, 0, n_rows * hop, axis=-1)
    rows = flat.reshape(*flat.shape[:-1], n_rows, hop)
    s_extra = -(-m_ctx // hop)  # ceil: extra row-shifts to cover m_ctx cols
    shifts = [rows]
    for k in range(1, s_extra + 1):
        start = (n_rows + k) * hop
        if xp.shape[-1] < start:
            cfgp = [(0, 0)] * (xp.ndim - 1) + [(0, start - xp.shape[-1])]
            xp = jnp.pad(xp, cfgp)
        nxt = jax.lax.slice_in_dim(xp, k * hop, start, axis=-1)
        shifts.append(nxt.reshape(*nxt.shape[:-1], n_rows, hop))
    ctx = jax.lax.slice_in_dim(jnp.concatenate(shifts, axis=-1), 0, m_ctx, axis=-1)

    dtype = xp.dtype
    L = max_lag + 1
    cc_re = cc_im = cs_r = ct = st = None
    if engine == "matmul":
        from modulation_mfcc.ops.pitch import _dft_mats, _dot

        kb, cs_c, ct, st = _dft_mats(m_ctx, nfft, L, dtype, want_sin=True)
        _, cs_r, _, _ = _dft_mats(hop, nfft, 1, dtype)
        pc = _dot(ctx, cs_c)
        cc_re, cc_im = pc[..., :kb], -pc[..., kb:]

        def _corr_rows(rseg, mats):
            """irfft(conj(rfft(rseg)) · rfft(ctx))[0:L] on the real planes."""
            pr = _dot(rseg, mats)
            rr_re, rr_im = pr[..., :kb], -pr[..., kb:]
            g_re = rr_re * cc_re + rr_im * cc_im
            g_im = rr_re * cc_im - rr_im * cc_re
            return _dot(g_re, ct) - _dot(g_im, st)

        p_full = _corr_rows(rows, cs_r)
    else:
        fc = jnp.fft.rfft(ctx, n=nfft, axis=-1)
        fr = jnp.fft.rfft(rows, n=nfft, axis=-1)
        # circular correlation == linear here: r + λ ≤ hop-1 + max_lag+1 < nfft
        p_full = jnp.fft.irfft(jnp.conj(fr) * fc, n=nfft, axis=-1)
    # energy row term = correlation against a ONES window = a difference of
    # prefix sums of C² — one cumsum replaces three transforms (rfft of C²
    # plus the full- and partial-window irffts); λ+hop ≤ m_ctx by
    # construction so every read stays inside the context
    s_inc = jnp.cumsum(ctx * ctx, axis=-1)

    # λ-aligned energy rows: index i carries λ = i+1 (window_sum lag_lo=0)
    q_lam = (
        jax.lax.slice_in_dim(s_inc, hop, hop + L, axis=-1)
        - jax.lax.slice_in_dim(s_inc, 0, L, axis=-1)
    )

    def window_sum(series_full, series_part, q, rem, lag_lo):
        """Σ_{b<q} series_full[f+b, lag] (+ series_part[f+q, lag])."""
        out = None
        take = jax.lax.slice_in_dim(series_full, lag_lo, lag_lo + L, axis=-1)
        for b in range(q):
            sl = jax.lax.slice_in_dim(take, b, b + nf, axis=-2)
            out = sl if out is None else out + sl
        if rem:
            tp = jax.lax.slice_in_dim(series_part, lag_lo, lag_lo + L, axis=-1)
            sl = jax.lax.slice_in_dim(tp, q, q + nf, axis=-2)
            out = sl if out is None else out + sl
        return out

    pp = None
    if rem1:
        rseg = jax.lax.slice_in_dim(rows, 0, rem1, axis=-1)
        if engine == "matmul":
            pp = _corr_rows(rseg, cs_r[:rem1])
        else:
            fr1 = jnp.fft.rfft(rseg, n=nfft, axis=-1)
            pp = jnp.fft.irfft(jnp.conj(fr1) * fc, n=nfft, axis=-1)
    cross = window_sum(p_full, pp, q1, rem1, 0)

    qp_lam = None
    if rem2:
        qp_lam = (
            jax.lax.slice_in_dim(s_inc, rem2, rem2 + L, axis=-1)
            - jax.lax.slice_in_dim(s_inc, 0, L, axis=-1)
        )
    e_tau = window_sum(q_lam, qp_lam, q2, rem2, 0)  # index i ↔ λ = τ+1
    return _cmndf_from_terms(cross, e_tau, dtype)


@lru_cache(maxsize=32)
def _beta_threshold_probs(n_thresholds: int, a: float, b: float) -> np.ndarray:
    thresholds = np.linspace(0, 1, n_thresholds + 1)
    cdf = scipy.stats.beta.cdf(thresholds, a, b)
    return np.diff(cdf)


def _boltzmann_pmf(k, lam, n):
    """Truncated discrete exponential (Boltzmann) pmf, matching
    scipy.stats.boltzmann.pmf(k, lam, N)."""
    return (1 - jnp.exp(-lam)) * jnp.exp(-lam * k) / (1 - jnp.exp(-lam * n) + 1e-30)


def _triang_window(m: int) -> np.ndarray:
    """scipy.signal.windows.triang(M, sym=True), host-side f64."""
    n = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        return np.concatenate([w, w[::-1]])
    w = 2.0 * n / (m + 1.0)
    return np.concatenate([w, w[-2::-1]])


@lru_cache(maxsize=32)
def _transition_local(n_states: int, width: float) -> np.ndarray:
    """librosa.sequence.transition_local(n, width, window='triangle',
    wrap=False), host-side f64: row i carries a triangular window of FULL
    length int(width) centered at column i (librosa's pad_center + roll
    construction), truncated at the band edges and row-normalized."""
    m = int(width)
    if m < 1:
        # librosa raises ParameterError for width < 1; without this the
        # empty triangle gives all-zero rows and 0/0 NaN normalization
        raise ValueError(f"transition window width {width} must be >= 1")
    if m > n_states:
        raise ValueError(f"transition window {m} exceeds n_states {n_states}")
    win = _triang_window(m)
    base = np.zeros(n_states)
    lo = (n_states - m) // 2  # librosa util.pad_center left offset
    base[lo : lo + m] = win
    trans = np.zeros((n_states, n_states))
    for i in range(n_states):
        row = np.roll(base, n_states // 2 + i + 1)
        row[min(n_states, i + m // 2 + 1) :] = 0
        row[: max(0, i - m // 2)] = 0
        trans[i] = row
    return trans / trans.sum(axis=1, keepdims=True)


@partial(
    jax.jit,
    static_argnames=(
        "sr",
        "fmin",
        "fmax",
        "frame_length",
        "win_length",
        "hop",
        "n_thresholds",
        "beta_parameters",
        "boltzmann_parameter",
        "resolution",
        "max_transition_rate",
        "switch_prob",
        "no_trough_prob",
        "center",
        "pad_mode",
        "cmndf_engine",
        "return_states",
    ),
)
def _pyin_f0_jit(
    x: jnp.ndarray,
    *,
    sr: float,
    fmin: float = 75.0,
    fmax: float = 600.0,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop: float = 0.01,
    n_thresholds: int = 100,
    beta_parameters: tuple = (2, 18),
    boltzmann_parameter: int = 2,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    center: bool = True,
    pad_mode: str = "constant",
    cmndf_engine: str = "auto",
    return_states: bool = False,
) -> jnp.ndarray:
    """F0 track [NF] in Hz; 0 where decoded unvoiced (caller maps to NaN).
    ``return_states=True`` additionally returns the decoded Viterbi state
    path [NF] int32 (state = bin, or bin + n_bins when unvoiced — the
    oracle's state convention) for path-score parity certificates.

    ``center``/``pad_mode`` follow librosa.pyin (reference passes
    pyincenter/pyinpad_mode through, script/calc.py:418-419): centered
    framing pads frame_length//2 on each side with the given numpy pad mode.

    ``cmndf_engine``: 'auto' (= 'fft', the librosa-parity form the
    float64 oracle pins bit-level) or 'matmul' (real-DFT matmul
    correlations at HIGHEST precision; equal up to float reduction order).
    """
    if win_length is None:
        win_length = frame_length // 2
    hop_length = max(1, int(round(hop * sr)))
    n = x.shape[-1]
    if center:
        pad = frame_length // 2
        xp = jnp.pad(x, (pad, pad), mode=pad_mode)
        # librosa frame count on the padded signal: for even frame_length
        # this is 1 + n//hop; odd frame_length loses one sample of span
        # (2·(fl//2) − fl = −1), one frame fewer when hop divides n
        nf = 1 + (n + 2 * pad - frame_length) // hop_length
    else:
        xp = x
        nf = max(1, 1 + (n - frame_length) // hop_length)
    # librosa.yin/pyin lag band: max_period is clipped so every read stays
    # inside the frame (d(τ) touches x[j ≤ win_length + τ]); non-default
    # win_length/fmin configs proceed with a narrower band instead of
    # erroring, exactly as the reference's librosa call does.
    min_lag = max(1, int(np.floor(sr / fmax)))
    max_lag_f0 = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    if max_lag_f0 <= min_lag:
        raise ValueError(
            f"frame_length={frame_length} too short for win_length="
            f"{win_length} with fmin={fmin}/fmax={fmax}: empty lag band"
        )
    # d(τ ≤ L) touches samples x[j ≤ w+L] only — so build the sliding
    # windows w+L+1 wide on the same grid and compute L+1 lags instead of
    # frame_length; at the 10 kHz defaults this shrinks the difference
    # function ~7.5×. Frameless path: window sums over global product
    # series (see _sliding_cmndf) — no frame matrix, no FFTs.
    ml = max_lag_f0
    engine = "fft" if cmndf_engine == "auto" else cmndf_engine
    cm = _sliding_cmndf(xp, nf, hop_length, win_length, ml, engine=engine)
    # All troughs live in the static lag band [min_lag, max_lag_f0] — the
    # threshold sweep below builds an [n_thresholds, NF, L] tensor, and on
    # the full lag axis (L≈frame_length/2) that is ~GBs per utterance; on
    # the band (L≈120 at default fmin/fmax)
    # the same computation is exact and two orders of magnitude smaller.
    cmb = jax.lax.slice_in_dim(cm, min_lag, max_lag_f0 + 1, axis=-1)  # [NF, L]
    lag = np.arange(min_lag, max_lag_f0 + 1)
    # librosa trough rules on the band (util.localmin with edge padding,
    # then the pyin first-bin override): interior strict-left/loose-right,
    # first bin iff band[0] < band[1], last bin iff band[-1] < band[-2].
    left = jnp.concatenate([cmb[..., :1], cmb[..., :-1]], axis=-1)
    right = jnp.concatenate([cmb[..., 1:], cmb[..., -1:]], axis=-1)
    is_trough = (cmb < left) & (cmb <= right)
    first = (cmb[..., :1] < cmb[..., 1:2])
    is_trough = jnp.concatenate([first, is_trough[..., 1:]], axis=-1)
    cm = cmb

    # parabolic refinement of the trough PERIOD only (librosa refines the
    # decoded frequency but thresholds on the raw CMNDF heights); band
    # edges get shift 0, and librosa zeroes |shift| > 1 rather than
    # clipping. denominator == 0 cannot happen at a genuine trough.
    denom = left - 2 * cm + right
    shift = jnp.where(denom != 0, 0.5 * (left - right) / denom, 0.0)
    shift = jnp.where(jnp.abs(shift) > 1.0, 0.0, shift)
    edge = np.zeros(len(lag), dtype=bool)
    edge[0] = edge[-1] = True
    shift = jnp.where(jnp.asarray(edge), 0.0, shift)
    lag_ref = jnp.asarray(lag, dtype=cm.dtype) + shift

    beta_probs = jnp.asarray(
        _beta_threshold_probs(n_thresholds, float(beta_parameters[0]), float(beta_parameters[1])),
        dtype=cm.dtype,
    )
    thresholds = jnp.asarray(np.linspace(0, 1, n_thresholds + 1)[1:], dtype=cm.dtype)

    big_val = jnp.where(is_trough, cm, jnp.inf)
    # Threshold sweep in SEGMENT form. The direct sweep materializes a
    # [n_thresholds, NF, L] chain (below mask, τ-cumsum rank, Boltzmann,
    # masked sum — ~6 device-memory passes over 100·NF·L); but along the threshold
    # axis everything is a step function that only jumps when a trough
    # ENTERS (its height crosses a threshold). Sorting troughs by height
    # turns the 100-threshold sum into a sum over at most K = ceil(L/2)
    # entry segments (strict-left local minima can't be adjacent): on
    # segment s (after the s+1 lowest troughs entered, before the next),
    # n_below = s+1 is constant and the Boltzmann rank of trough j is
    # pos[j,s] = #{entered troughs preceding τ_j} — a prefix count over
    # the height order, i.e. ONE [K,K] matmul against a triangular mask
    # (0/1 operands, counts ≤ K << 256: integer-exact at any precision;
    # HIGHEST is stated so no float32 product here is left to a default). Segment beta masses come from the
    # difference of per-trough tail masses A_j = Σ_i β_i·[h_j < thr_i], so
    # no gather/searchsorted anywhere; the stable sort keeps τ order on
    # ties, matching librosa's in-order fancy assignment. Net: the sweep
    # drops from 100·NF·L to NF·K·K elements (~6× less traffic at the
    # 10 kHz defaults) and measures ~2× on the whole pyin pipeline.
    L = cmb.shape[-1]
    K = (L + 1) // 2
    idx0 = jnp.broadcast_to(
        jnp.arange(L, dtype=jnp.int32), big_val.shape
    )
    hs, taus = jax.lax.sort((big_val, idx0), dimension=-1, num_keys=1)
    hK = jax.lax.slice_in_dim(hs, 0, K, axis=-1)  # heights, ascending
    tK = jax.lax.slice_in_dim(taus, 0, K, axis=-1)  # their lag slots

    # A_j: beta mass of thresholds ABOVE trough j's height (h_j < thr_i is
    # librosa's strict 'below'); pads (h = inf) get A = 0. Segment masses
    # are adjacent differences: W_s = A_s − A_{s+1}, W_{last real} = A.
    A = jnp.sum(
        jnp.where(hK[..., None] < thresholds, beta_probs, 0.0), axis=-1
    )
    W = A - jnp.concatenate(
        [A[..., 1:], jnp.zeros_like(A[..., :1])], axis=-1
    )

    # pos[j, s] = # troughs among the s+1 lowest strictly preceding τ_j
    # (self contributes 0 — librosa's rank counts strictly-earlier below
    # troughs); trough j is active on segments s ≥ j.
    prec = (tK[..., :, None] > tK[..., None, :]).astype(cm.dtype)
    upper = jnp.asarray(np.triu(np.ones((K, K))), dtype=cm.dtype)
    pos = jnp.matmul(prec, upper, precision=jax.lax.Precision.HIGHEST)  # [.., j, s]
    n_s = jnp.asarray(np.arange(1, K + 1), dtype=cm.dtype)
    prior = _boltzmann_pmf(pos, float(boltzmann_parameter), n_s)
    active = jnp.asarray(np.triu(np.ones((K, K), dtype=bool)))  # s ≥ j
    probs_sorted = jnp.sum(
        jnp.where(active, prior, 0.0) * W[..., None, :], axis=-1
    )

    # scatter back to lag order via one-hot compare-multiply-reduce (the
    # per-row lag ids tK are unique, so the one-hot sum IS the unsort):
    # this [NF, K, L] compare+select fuses into the reduction and streams,
    # where a second lax.sort would not. Rows whose trough count < K carry padded
    # slots (tK from inf heights) — their probs_sorted mass is exactly 0
    # (W vanishes past the last real segment), so they add nothing.
    lanes = jnp.arange(L, dtype=tK.dtype)
    probs = jnp.sum(
        jnp.where(tK[..., :, None] == lanes, probs_sorted[..., :, None], 0.0),
        axis=-2,
    )

    # thresholds with no trough below them → no_trough_prob mass at the
    # LOWEST TROUGH (librosa: argmin of trough heights — which may differ
    # from the raw band argmin when the band minimum is not a local min;
    # the stable height sort puts exactly that trough first), and only
    # when the frame has at least one trough (librosa `continue`s
    # troughless frames, leaving them all-unvoiced).
    miss_mass = jnp.sum(
        jnp.where(hK[..., :1] >= thresholds, beta_probs, 0.0), axis=-1
    )
    has_trough = jnp.isfinite(hK[..., 0])
    gmin = tK[..., 0]  # first lowest trough
    probs = probs + (
        no_trough_prob
        * miss_mass[..., None]
        * jnp.where(has_trough, 1.0, 0.0)[..., None]
        * jax.nn.one_hot(gmin, probs.shape[-1], dtype=cm.dtype)
    )

    freqs = sr / jnp.maximum(lag_ref, jnp.finfo(cm.dtype).tiny)

    # pitch-bin grid (librosa: ceil(1/resolution) bins per semitone)
    nbps = int(np.ceil(1.0 / resolution))
    n_bins = int(np.floor(12.0 * nbps * np.log2(fmax / fmin))) + 1
    bin_f = jnp.round(12.0 * nbps * jnp.log2(jnp.maximum(freqs, 1e-12) / fmin))
    # librosa clips the rounded bin into [0, n_bins] INCLUSIVE — index
    # n_bins lands in the unvoiced block whose rows are then overwritten,
    # so candidates rounding above the top bin are dropped entirely.
    keep = bin_f <= (n_bins - 1)
    bin_idx = jnp.clip(bin_f.astype(jnp.int32), 0, n_bins - 1)
    # bin projection as a fused one-hot reduction (the compare-multiply-
    # reduce fuses; a scatter-add does not).
    # librosa's fancy assignment is last-write-wins on duplicate bins —
    # which DOES occur (e.g. 44.1 kHz defaults: adjacent troughs round to
    # one bin for lags ≳346 at 10 bins/semitone). librosa scatters only
    # the POSITIVE-prob entries (np.nonzero(yin_probs)), so the LWW
    # competition runs over candidates = kept positive-prob troughs, NOT
    # the whole lag axis (a zero-prob neighbor sharing the bin must not
    # knock a real trough out). Exact LWW without a scatter: refined lags
    # strictly increase across troughs (troughs are ≥2 apart, |shift| < 1
    # zeroed past ±1), so candidate bins are NON-INCREASING along τ and
    # colliding bins are contiguous — candidate k wins its bin iff the
    # nearest candidate to its right (= the running max of candidate bins
    # over k' > k) carries a different bin.
    cand = keep & (probs > 0)
    bmask = jnp.where(cand, bin_idx, -1)
    rmax = jnp.flip(
        jax.lax.cummax(jnp.flip(bmask, -1), axis=bmask.ndim - 1), -1
    )
    rmax_next = jnp.concatenate(
        [rmax[..., 1:], jnp.full_like(rmax[..., :1], -1)], axis=-1
    )  # max candidate bin strictly to the right
    win = cand & (bin_idx != rmax_next)
    obs_v = jnp.sum(
        jnp.where(win, probs, 0.0)[..., None]
        * (bin_idx[..., None] == jnp.arange(n_bins)),
        axis=-2,
    )
    voiced_prob = jnp.clip(jnp.sum(obs_v, axis=-1), 0.0, 1.0)
    obs_u = jnp.broadcast_to(((1.0 - voiced_prob) / n_bins)[:, None], obs_v.shape)
    obs = jnp.concatenate([obs_v, obs_u], axis=-1)  # [NF, 2*n_bins]

    # transition matrix: librosa transition_local triangular window (FULL
    # length int(rate·12·nbps·hop/sr) — not a half-width) kron'd with the
    # voiced/unvoiced switch loop
    twidth = max_transition_rate * 12.0 * nbps * hop_length / sr
    tri = _transition_local(n_bins, twidth)
    tiny = float(jnp.finfo(cm.dtype).tiny)
    # The full [2n, 2n] transition is kron([[1-s, s], [s, 1-s]], tri). In
    # max-plus (log) space the block structure factors the relaxation:
    #     δ'_V[v] = max_u ( max(δ_V[u]+log(1-s), δ_U[u]+log s) + log tri[u,v] )
    # and symmetrically for δ'_U — two [n,n] max-plus products after a cheap
    # [n] elementwise max, HALF the flops of the direct [2n,2n] product.
    # log((1-s)·tri + tiny) is replaced by log(1-s) + log(tri + tiny): equal
    # up to ulps (and -inf vs log(tiny) on the triangle's zero corners, which
    # can never win the max since every column has nonzero support), so the
    # decoded path still matches librosa's argmax over the dense matrix;
    # only exact cross-block score ties (measure-zero) could tie-break
    # differently.
    ltri_np = np.log(tri + tiny)
    log_tri = jnp.asarray(ltri_np, dtype=cm.dtype)
    c_stay = jnp.asarray(np.log(1.0 - switch_prob), dtype=cm.dtype)
    c_sw = jnp.asarray(np.log(switch_prob), dtype=cm.dtype)
    log_obs = jnp.log(obs + tiny)

    # The dense [n,n] max-plus relax beat every banded formulation tried
    # (per-column gathers; a static-shift band with a global log(tiny)
    # floor): one regular fused broadcast-add-max over [n,n] per step.

    # Forward pass emits NO backpointers — only the per-step max plus the
    # incoming delta as scan output. The argmax that classic Viterbi
    # stores per (step, state) is a second full reduction; the backtrace
    # below recomputes it from the saved deltas only along the single
    # decoded path — an O(n)-per-step rescan with bit-identical argmax
    # inputs, so the decoded path is unchanged.
    def vstep(delta, lo):
        d_v, d_u = delta[:n_bins], delta[n_bins:]
        # per-source best block, voiced preferred on ties (its state index
        # is lower, matching argmax-first over the dense [2n, 2n] scores)
        m_v = jnp.maximum(d_v + c_stay, d_u + c_sw)
        m_u = jnp.maximum(d_v + c_sw, d_u + c_stay)
        new = jnp.concatenate(
            [
                jnp.max(m_v[:, None] + log_tri, axis=0),
                jnp.max(m_u[:, None] + log_tri, axis=0),
            ]
        )
        return new + lo, delta

    # librosa p_init: uniform over the UNVOICED states only
    p_init = np.zeros(2 * n_bins)
    p_init[n_bins:] = 1.0 / n_bins
    delta0 = log_obs[0] + jnp.asarray(np.log(p_init + tiny), dtype=cm.dtype)
    # unroll: the [S,S] max-plus body is small relative to the per-step
    # scan overhead at S=720; unrolling amortizes it 8x
    delta_f, delta_hist = jax.lax.scan(vstep, delta0, log_obs[1:], unroll=8)
    last = jnp.argmax(delta_f if nf > 1 else delta0)

    log_tri_t = log_tri.T  # row v = log_tri[:, v]: per-step column readout

    def back(nxt, delta_prev):
        d_v, d_u = delta_prev[:n_bins], delta_prev[n_bins:]
        voiced_t = nxt < n_bins
        pos = jnp.where(voiced_t, nxt, nxt - n_bins)
        a = jnp.where(voiced_t, c_stay, c_sw)
        b = jnp.where(voiced_t, c_sw, c_stay)
        m = jnp.maximum(d_v + a, d_u + b)
        sel = (d_u + b) > (d_v + a)  # True: source was unvoiced
        col = jax.lax.dynamic_slice_in_dim(log_tri_t, pos, 1, axis=0)[0]
        base = jnp.argmax(m + col)
        cur = base + n_bins * sel[base].astype(base.dtype)
        return cur, cur

    _, path_rev = jax.lax.scan(back, last, delta_hist, reverse=True, unroll=8)
    path = jnp.concatenate([path_rev, jnp.asarray([last])])
    voiced = path < n_bins
    bin_of = jnp.where(voiced, path, path - n_bins)
    f0 = fmin * 2.0 ** (bin_of.astype(cm.dtype) / (12.0 * nbps))
    out = jnp.where(voiced, f0, 0.0)
    if return_states:
        return out, path.astype(jnp.int32)
    return out


_CMNDF_ENGINES = ("auto", "fft", "matmul")


def pyin_f0(x: jnp.ndarray, *, cmndf_engine: str = "auto", **kw) -> jnp.ndarray:
    """Public entry — see ``_pyin_f0_jit`` for the full signature/docs.

    Validates the engine name here (not in the traced body): an unknown
    value must error, not silently run the default."""
    if cmndf_engine not in _CMNDF_ENGINES:
        raise ValueError(f"cmndf_engine {cmndf_engine!r} not in {_CMNDF_ENGINES}")
    return _pyin_f0_jit(x, cmndf_engine=cmndf_engine, **kw)
