"""HTML pages for the viewer server (first-party, no template engine).

Functional parity targets: ``reference DigiPathAI/templates/files.html``
(slide table with mask status), ``templates/viewer.html`` (viewer with mask +
uncertainty overlays, tissue-type dropdown, segment button, 2s status
polling) and ``templates/about.html`` — rebuilt as plain HTML strings with a
first-party JS viewer instead of the vendored OpenSeadragon.
"""

from __future__ import annotations

import html
import json

_BASE_CSS = """
body { font-family: system-ui, sans-serif; margin: 0; background: #f5f6f8; color: #222; }
header { background: #263238; color: #fff; padding: 10px 18px; display: flex; align-items: center; gap: 18px; }
header a { color: #cfd8dc; text-decoration: none; font-weight: 600; }
header a:hover { color: #fff; }
.wrap { padding: 18px; }
table { border-collapse: collapse; background: #fff; width: 100%; box-shadow: 0 1px 3px rgba(0,0,0,.12); }
th, td { text-align: left; padding: 8px 14px; border-bottom: 1px solid #eceff1; }
tr:hover td { background: #f1f8ff; }
.badge { padding: 2px 8px; border-radius: 10px; font-size: 12px; }
.badge.ok { background: #c8e6c9; color: #1b5e20; }
.badge.no { background: #ffcdd2; color: #b71c1c; }
button, select { font: inherit; padding: 6px 10px; }
#controls { position: absolute; top: 12px; right: 12px; z-index: 10; background: rgba(255,255,255,.95);
  padding: 12px; border-radius: 8px; width: 240px; box-shadow: 0 2px 8px rgba(0,0,0,.3); }
#controls label { display: block; margin: 6px 0 2px; font-size: 13px; }
#progress-outer { background: #eee; height: 10px; border-radius: 5px; margin-top: 8px; display: none; }
#progress-inner { background: #1976d2; width: 0%; height: 100%; border-radius: 5px; transition: width .3s; }
#dpai-scalebar { position: absolute; bottom: 14px; left: 14px; z-index: 10; border-bottom: 4px solid #fff;
  color: #fff; font-size: 12px; text-shadow: 0 0 3px #000; text-align: center; }
#status-line { font-size: 13px; margin-top: 6px; min-height: 17px; }
"""


def _header() -> str:
    return ("<header><a href='/'>DigiPathAI-TPU</a>"
            "<a href='/about'>About</a></header>")


def page_files(entries) -> str:
    """entries: list of dicts {name, url_path, mask_present, is_dir, depth}."""
    rows = []
    for e in entries:
        indent = "&nbsp;" * 4 * e.get("depth", 0)
        if e.get("is_dir"):
            rows.append(f"<tr><td colspan=2>{indent}<b>{html.escape(e['name'])}/</b></td></tr>")
        else:
            badge = ("<span class='badge ok'>Available</span>" if e["mask_present"]
                     else "<span class='badge no'>Not Available</span>")
            href = "/" + e["url_path"]
            rows.append(
                f"<tr><td>{indent}<a href='{html.escape(href)}'>"
                f"{html.escape(e['name'])}</a></td><td>Mask Status: {badge}</td></tr>")
    body = "\n".join(rows) or "<tr><td>No slides found</td></tr>"
    return f"""<!doctype html><html><head><title>DigiPathAI-TPU</title>
<style>{_BASE_CSS}</style></head><body>{_header()}
<div class="wrap"><h2>Slides</h2>
<table><tr><th>Slide</th><th>Segmentation</th></tr>{body}</table></div>
</body></html>"""


def page_viewer(slide_url: str, mask_url, uncertainty_url, viewer_only: bool,
                properties: dict, slide_filename: str, slide_mpp: float) -> str:
    sources = [{"url": slide_url, "opacity": 1.0}]
    if mask_url:
        sources.append({"url": mask_url, "opacity": 0.0})
    if uncertainty_url:
        sources.append({"url": uncertainty_url, "opacity": 0.0})
    props_html = "".join(
        f"<div><b>{html.escape(str(k))}</b>: {html.escape(str(v))}</div>"
        for k, v in (properties or {}).items())
    seg_controls = "" if viewer_only else f"""
  <label for="tissuetype">Tissue type</label>
  <select id="tissuetype">
    <option value="Colon">Colon</option>
    <option value="Liver">Liver</option>
    <option value="Breast">Breast</option>
  </select>
  <button id="segment-btn" style="margin-top:8px;width:100%">Run segmentation</button>
  <div id="progress-outer"><div id="progress-inner"></div></div>
  <div id="status-line"></div>"""
    mask_controls = f"""
  <label><input type="checkbox" id="mask-toggle" {'disabled' if not mask_url else ''}> Show mask</label>
  <label><input type="checkbox" id="unc-toggle" {'disabled' if not uncertainty_url else ''}> Show uncertainty</label>
  <label for="overlay-opacity">Overlay opacity</label>
  <input type="range" id="overlay-opacity" min="0" max="100" value="50" style="width:100%">"""
    return f"""<!doctype html><html><head>
<title>{html.escape(slide_filename)} — DigiPathAI-TPU</title>
<style>{_BASE_CSS}
html, body, #viewer-root {{ height: 100%; }}
#viewer {{ position: absolute; top: 46px; bottom: 0; left: 0; right: 0; }}
</style></head><body>{_header()}
<div id="viewer"></div>
<div id="controls">
  <div style="font-weight:600">{html.escape(slide_filename)}</div>
  {props_html}
  {mask_controls}
  {seg_controls}
</div>
<div id="dpai-scalebar" style="display:none"></div>
<script src="/static/dpai/viewer.js"></script>
<script>
const SOURCES = {json.dumps(sources).replace('</', '<\\/')};
const MASK_IDX = {1 if mask_url else -1};
const UNC_IDX = {2 if mask_url and uncertainty_url else (1 if uncertainty_url else -1)};
const viewer = new DPAIViewer("viewer", SOURCES);
viewer.mpp = {float(slide_mpp or 0)};
viewer.init();

function overlayOpacity() {{
  return document.getElementById("overlay-opacity").value / 100.0;
}}
function syncOverlays() {{
  const op = overlayOpacity();
  if (MASK_IDX >= 0)
    viewer.setOpacity(MASK_IDX, document.getElementById("mask-toggle").checked ? op : 0);
  if (UNC_IDX >= 0)
    viewer.setOpacity(UNC_IDX, document.getElementById("unc-toggle").checked ? op : 0);
}}
for (const id of ["mask-toggle", "unc-toggle", "overlay-opacity"]) {{
  const el = document.getElementById(id);
  if (el) el.addEventListener("input", syncOverlays);
}}

const segBtn = document.getElementById("segment-btn");
if (segBtn) {{
  segBtn.addEventListener("click", async () => {{
    segBtn.disabled = true;
    document.getElementById("progress-outer").style.display = "block";
    const tissue = document.getElementById("tissuetype").value;
    await fetch("/segment", {{
      method: "POST",
      headers: {{"Content-Type": "application/x-www-form-urlencoded"}},
      body: "tissuetype=" + encodeURIComponent(tissue),
    }});
    const poll = setInterval(async () => {{
      const st = await (await fetch("/check_segment_status")).json();
      document.getElementById("status-line").textContent = st.status || "";
      document.getElementById("progress-inner").style.width = (st.progress || 0) + "%";
      if (st.status === "Done") {{ clearInterval(poll); location.reload(); }}
      if (st.status === "Error") {{ clearInterval(poll); segBtn.disabled = false; }}
    }}, 2000);
  }});
}}
</script></body></html>"""


def page_about() -> str:
    return f"""<!doctype html><html><head><title>About — DigiPathAI-TPU</title>
<style>{_BASE_CSS}</style></head><body>{_header()}
<div class="wrap"><h2>DigiPathAI-TPU</h2>
<p>A TPU-native whole-slide-image viewer and cancer-segmentation framework:
a JAX/XLA inference engine (DenseNet-U-Net, Inception-ResNet-v2 U-Net and
DeepLabv3+ ensemble with test-time augmentation, on-device overlap-add
stitching and uncertainty estimation) behind a Deep Zoom tile server.</p>
<p>Segmentation produces three artifacts per slide: a probability map, a
binary mask overlay and an epistemic-uncertainty overlay.</p></div>
</body></html>"""
