"""Interactive analysis view — a single self-contained HTML file.

The reference's remaining GUI-only capabilities (SURVEY.md §2c "Misc UI" and
§2d SyncCursor) are interactive chrome on top of the same data the
scriptable session computes:

  * Crosshair (ui.py:33-94)          → a synced vertical cursor + per-curve
                                       value readout across every panel
  * SyncCursor (main.py:2105-2154)   → the same cursor mirrored on all
                                       panels and the audio row
  * ZoomToolbar (ui.py:172-239)      → drag-to-zoom on x, wheel zoom,
                                       in/out/reset buttons, double-click
                                       reset; all panels x-linked
  * Spectrogram toggle
    (quadruple_axis_plot_item.py:470) → checkbox showing/hiding the
                                       spectrogram image under the waveform

This module renders them without a Qt event loop: curves, peaks, TextGrid
tiers, the selection region and the waveform/spectrogram are embedded as
JSON + a base64 PNG in one HTML file with hand-rolled canvas JS (no external
libraries, no network). Open in any browser.
"""
from __future__ import annotations

import base64
import io
import json

import numpy as np

__all__ = ["export_interactive_html"]

_COLORS = ("#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#8c564b")


def _downsample_curve(x, y, max_points: int = 4000):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) > max_points:
        idx = np.linspace(0, len(x) - 1, max_points).astype(int)
        x, y = x[idx], y[idx]
    y = np.where(np.isfinite(y), y, np.nan)
    return x, y


def _waveform_envelope(samples, sr: float, columns: int = 2000):
    """Per-column (min, max) pairs — the standard waveform display reduce."""
    s = np.asarray(samples, dtype=np.float64)
    n = len(s)
    edges = np.linspace(0, n, columns + 1).astype(int)
    mins = np.empty(columns)
    maxs = np.empty(columns)
    for c in range(columns):
        seg = s[edges[c] : max(edges[c] + 1, edges[c + 1])]
        mins[c] = seg.min()
        maxs[c] = seg.max()
    t = (edges[:-1] + edges[1:]) / 2.0 / sr
    return t, mins, maxs


def _spectrogram_png(spec) -> str | None:
    """Greyscale dB spectrogram → base64 PNG data URI (Greys LUT like the
    reference's praat_py_ui/spectrogram.py)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    m = np.asarray(spec.data_matrix, dtype=np.float64)
    buf = io.BytesIO()
    plt.imsave(buf, m[::-1], cmap="Greys", format="png")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _clean(v):
    """JSON with NaN → null (strict-JSON parsers in browsers reject NaN)."""
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


def _num_list(arr):
    return [_clean(float(v)) for v in np.asarray(arr, dtype=np.float64)]


def export_interactive_html(session, out: str, *, show_spectrogram: bool = True) -> str:
    """Write the session's curves/panels/annotations as an interactive HTML
    file. Returns ``out``."""
    panels: dict[int, list] = {}
    for c in session.curves.values():
        if not c.visible:
            continue
        x, y = _downsample_curve(c.times, c.values)
        entry = {
            "name": c.name,
            "color": c.color or _COLORS[len(panels.get(c.panel, [])) % len(_COLORS)],
            "scatter": c.feature.startswith("formant"),
            "x": _num_list(x),
            "y": _num_list(y),
            "minPeaks": [_num_list(c.min_peaks[0]), _num_list(c.min_peaks[1])],
            "maxPeaks": [_num_list(c.max_peaks[0]), _num_list(c.max_peaks[1])],
        }
        panels.setdefault(c.panel, []).append(entry)

    amp = np.asarray(session.sound.amplitudes)
    if amp.ndim > 1:
        amp = amp[0]  # first channel, like the reference's waveform widget
    wt, wmin, wmax = _waveform_envelope(amp, session.sound.sample_rate)
    tiers = []
    if session.textgrid is not None:
        for tier in session.textgrid.tiers:
            ivs = getattr(tier, "intervals", None)
            if ivs is not None:
                tiers.append(
                    {
                        "name": tier.name,
                        "intervals": [[iv.start, iv.end, iv.text] for iv in ivs],
                    }
                )
    duration = amp.shape[-1] / session.sound.sample_rate
    data = {
        "duration": duration,
        "region": list(session.region) if session.region else None,
        "panels": [panels[k] for k in sorted(panels)],
        "wave": {"t": _num_list(wt), "lo": _num_list(wmin), "hi": _num_list(wmax)},
        "tiers": tiers,
        "title": str(session.audio_path),
    }
    spec_uri = _spectrogram_png(session.spectrogram) if show_spectrogram else None
    html = _TEMPLATE.replace("__DATA__", json.dumps(data)).replace(
        "__SPEC__", json.dumps(spec_uri)
    )
    with open(out, "w") as f:
        f.write(html)
    return out


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>modulation_mfcc session</title>
<style>
 body { font-family: sans-serif; margin: 12px; background: #fafafa; }
 .panel { position: relative; margin-bottom: 6px; }
 canvas { display: block; border: 1px solid #ccc; background: #fff; }
 .speclayer { position: absolute; left: 60px; top: 0; pointer-events: none; }
 #toolbar { margin-bottom: 8px; }
 #readout { font: 12px monospace; min-height: 2.5em; white-space: pre; }
 button { margin-right: 4px; }
</style></head><body>
<div id="toolbar">
 <button id="zin">Zoom in</button><button id="zout">Zoom out</button>
 <button id="zreset">Reset</button>
 <label><input type="checkbox" id="spectoggle" checked> spectrogram</label>
 <span id="title"></span>
</div>
<div id="readout">&nbsp;</div>
<div id="plots"></div>
<script>
const DATA = __DATA__;
const SPEC = __SPEC__;
const W = 960, H = 150, AXW = 60;
let view = [0, DATA.duration];
let cursorT = null;
const panels = [];

function makeCanvas(parent) {
  const div = document.createElement('div'); div.className = 'panel';
  const cv = document.createElement('canvas');
  cv.width = W + AXW; cv.height = H; div.appendChild(cv);
  parent.appendChild(div);
  return {div, cv, ctx: cv.getContext('2d')};
}
function x2px(t) { return AXW + (t - view[0]) / (view[1] - view[0]) * W; }
function px2x(p) { return view[0] + (p - AXW) / W * (view[1] - view[0]); }

function drawPanel(p) {
  const ctx = p.ctx; ctx.clearRect(0, 0, W + AXW, H);
  if (DATA.region) {
    ctx.fillStyle = 'rgba(255,220,100,0.3)';
    const a = x2px(DATA.region[0]), b = x2px(DATA.region[1]);
    ctx.fillRect(a, 0, b - a, H);
  }
  let lo = Infinity, hi = -Infinity;
  for (const c of p.curves) for (let i = 0; i < c.x.length; i++) {
    if (c.x[i] < view[0] || c.x[i] > view[1] || c.y[i] === null) continue;
    if (c.y[i] < lo) lo = c.y[i]; if (c.y[i] > hi) hi = c.y[i];
  }
  if (!isFinite(lo)) { lo = 0; hi = 1; }
  if (hi - lo < 1e-12) { hi = lo + 1; }
  const pad = 0.06 * (hi - lo); lo -= pad; hi += pad;
  p.ylim = [lo, hi];
  const y2px = v => H - (v - lo) / (hi - lo) * H;
  for (const c of p.curves) {
    ctx.strokeStyle = c.color; ctx.fillStyle = c.color; ctx.lineWidth = 1.2;
    if (c.scatter) {
      for (let i = 0; i < c.x.length; i++) {
        if (c.y[i] === null) continue;
        ctx.fillRect(x2px(c.x[i]) - 1, y2px(c.y[i]) - 1, 2, 2);
      }
    } else {
      ctx.beginPath(); let pen = false;
      for (let i = 0; i < c.x.length; i++) {
        if (c.y[i] === null) { pen = false; continue; }
        const px = x2px(c.x[i]), py = y2px(c.y[i]);
        if (pen) ctx.lineTo(px, py); else { ctx.moveTo(px, py); pen = true; }
      }
      ctx.stroke();
    }
    for (const [pk, mark] of [[c.maxPeaks, '▲'], [c.minPeaks, '▼']]) {
      ctx.font = '9px sans-serif';
      for (let i = 0; i < pk[0].length; i++)
        ctx.fillText(mark, x2px(pk[0][i]) - 4, y2px(pk[1][i]) - 3);
    }
  }
  // y axis labels
  ctx.fillStyle = '#333'; ctx.font = '10px sans-serif';
  ctx.fillText(hi.toPrecision(4), 2, 10);
  ctx.fillText(lo.toPrecision(4), 2, H - 3);
  // tick grid on x
  ctx.strokeStyle = '#eee';
  const span = view[1] - view[0];
  const step = Math.pow(10, Math.floor(Math.log10(span / 5)));
  for (let t = Math.ceil(view[0] / step) * step; t < view[1]; t += step) {
    ctx.beginPath(); ctx.moveTo(x2px(t), 0); ctx.lineTo(x2px(t), H); ctx.stroke();
    ctx.fillText(t.toFixed(Math.max(0, -Math.floor(Math.log10(step)))), x2px(t) + 2, H - 3);
  }
  if (cursorT !== null && cursorT >= view[0] && cursorT <= view[1]) {
    ctx.strokeStyle = '#888'; ctx.setLineDash([4, 3]);
    ctx.beginPath(); ctx.moveTo(x2px(cursorT), 0); ctx.lineTo(x2px(cursorT), H);
    ctx.stroke(); ctx.setLineDash([]);
  }
  if (p.drag) {
    ctx.fillStyle = 'rgba(100,150,255,0.25)';
    ctx.fillRect(p.drag[0], 0, p.drag[1] - p.drag[0], H);
  }
}

function drawWave(p) {
  drawPanel(p);  // grid/cursor/region via empty curve list, then overlay wave
  const ctx = p.ctx;
  let lo = Infinity, hi = -Infinity;
  const w = DATA.wave;
  for (let i = 0; i < w.t.length; i++) {
    if (w.t[i] < view[0] || w.t[i] > view[1]) continue;
    if (w.lo[i] < lo) lo = w.lo[i]; if (w.hi[i] > hi) hi = w.hi[i];
  }
  if (!isFinite(lo)) { lo = -1; hi = 1; }
  const y2px = v => H - (v - lo) / (hi - lo || 1) * H;
  ctx.strokeStyle = '#2a2a2a'; ctx.lineWidth = 1;
  for (let i = 0; i < w.t.length; i++) {
    if (w.t[i] < view[0] || w.t[i] > view[1]) continue;
    const px = x2px(w.t[i]);
    ctx.beginPath(); ctx.moveTo(px, y2px(w.lo[i])); ctx.lineTo(px, y2px(w.hi[i])); ctx.stroke();
  }
  // TextGrid interval boundaries + centered labels (DisplayInterval parity)
  ctx.font = '10px sans-serif';
  let row = 0;
  for (const tier of DATA.tiers) {
    for (const [a, b, label] of tier.intervals) {
      ctx.strokeStyle = '#c33'; ctx.setLineDash([3, 3]);
      for (const t of [a, b]) if (t >= view[0] && t <= view[1]) {
        ctx.beginPath(); ctx.moveTo(x2px(t), 0); ctx.lineTo(x2px(t), H); ctx.stroke();
      }
      ctx.setLineDash([]);
      const mid = (a + b) / 2;
      if (label && mid >= view[0] && mid <= view[1]) {
        ctx.fillStyle = '#c33';
        ctx.fillText(label, x2px(mid) - 3 * label.length, 12 + 11 * row);
      }
    }
    row++;
  }
}

function redraw() {
  for (const p of panels) (p.isWave ? drawWave : drawPanel)(p);
  if (specImg) positionSpec();
}

function readout() {
  const el = document.getElementById('readout');
  if (cursorT === null) { el.textContent = ' '; return; }
  let lines = ['t = ' + cursorT.toFixed(4) + ' s'];
  for (const p of panels) {
    for (const c of p.curves || []) {
      let best = -1, bd = Infinity;
      for (let i = 0; i < c.x.length; i++) {
        const d = Math.abs(c.x[i] - cursorT);
        if (d < bd) { bd = d; best = i; }
      }
      if (best >= 0 && c.y[best] !== null)
        lines.push(c.name + ' = ' + c.y[best].toPrecision(5));
    }
  }
  el.textContent = lines.join('   ');
}

function setView(a, b) {
  a = Math.max(0, a); b = Math.min(DATA.duration, b);
  if (b - a < 1e-4) return;
  view = [a, b]; redraw();
}

const plots = document.getElementById('plots');
document.getElementById('title').textContent = DATA.title;
let specImg = null;
// audio row first (the reference's layout: waveform on top)
{
  const p = makeCanvas(plots); p.isWave = true; p.curves = []; panels.push(p);
  if (SPEC) {
    specImg = document.createElement('img');
    specImg.src = SPEC; specImg.className = 'speclayer';
    specImg.style.opacity = 0.55;
    p.div.appendChild(specImg);
    p.specDiv = p.div;
  }
}
function positionSpec() {
  // the spectrogram spans the full recording; scale/offset it to the view
  const scale = DATA.duration / (view[1] - view[0]);
  specImg.style.width = (W * scale) + 'px';
  specImg.style.height = H + 'px';
  specImg.style.left = (AXW - (view[0] / (view[1] - view[0])) * W) + 'px';
  specImg.style.clipPath = 'inset(0 0 0 0)';
}
for (const curves of DATA.panels) {
  const p = makeCanvas(plots); p.curves = curves; panels.push(p);
}
for (const p of panels) {
  p.cv.addEventListener('mousemove', ev => {
    const r = p.cv.getBoundingClientRect();
    const px = ev.clientX - r.left;
    if (p.dragStart !== undefined) p.drag = [p.dragStart, px];
    cursorT = px2x(px);         // SyncCursor: one cursor, every panel
    redraw(); readout();
  });
  p.cv.addEventListener('mousedown', ev => {
    const r = p.cv.getBoundingClientRect();
    p.dragStart = ev.clientX - r.left;
  });
  p.cv.addEventListener('mouseup', ev => {
    const r = p.cv.getBoundingClientRect();
    const px = ev.clientX - r.left;
    if (p.dragStart !== undefined && Math.abs(px - p.dragStart) > 5) {
      const a = px2x(Math.min(p.dragStart, px)), b = px2x(Math.max(p.dragStart, px));
      setView(a, b);
    }
    p.dragStart = undefined; p.drag = null; redraw();
  });
  p.cv.addEventListener('dblclick', () => setView(0, DATA.duration));
  p.cv.addEventListener('wheel', ev => {
    ev.preventDefault();
    const r = p.cv.getBoundingClientRect();
    const t0 = px2x(ev.clientX - r.left);
    const f = ev.deltaY > 0 ? 1.25 : 0.8;
    setView(t0 - (t0 - view[0]) * f, t0 + (view[1] - t0) * f);
  });
  p.cv.addEventListener('mouseleave', () => { cursorT = null; redraw(); readout(); });
}
function zoomBy(f) {
  const mid = (view[0] + view[1]) / 2, half = (view[1] - view[0]) / 2 * f;
  setView(mid - half, mid + half);
}
document.getElementById('zin').onclick = () => zoomBy(0.5);
document.getElementById('zout').onclick = () => zoomBy(2.0);
document.getElementById('zreset').onclick = () => setView(0, DATA.duration);
document.getElementById('spectoggle').onchange = ev => {
  if (specImg) specImg.style.display = ev.target.checked ? '' : 'none';
};
if (!SPEC) document.getElementById('spectoggle').disabled = true;
redraw();
</script></body></html>
"""
