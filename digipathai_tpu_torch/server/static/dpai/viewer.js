/* DigiPathAI-TPU first-party Deep Zoom viewer.
 *
 * A compact tiled-pyramid viewer speaking the standard Deep Zoom protocol
 * (.dzi descriptor + _files/<level>/<col>_<row>.<fmt> tiles) with layered
 * sources (slide + mask + uncertainty overlays with adjustable opacity),
 * pan (drag), zoom (wheel), and scale bar. Written from scratch for this
 * project; no third-party viewer code.
 */
"use strict";

class DZSource {
  constructor(baseUrl) {
    this.baseUrl = baseUrl; // e.g. "/foo.tiff" -> dzi at "/foo.tiff.dzi"
    this.ready = false;
  }
  async load() {
    const resp = await fetch(this.baseUrl + ".dzi");
    if (!resp.ok) throw new Error("dzi fetch failed: " + this.baseUrl);
    const xml = new DOMParser().parseFromString(await resp.text(), "text/xml");
    const img = xml.getElementsByTagName("Image")[0];
    const size = xml.getElementsByTagName("Size")[0];
    this.tileSize = parseInt(img.getAttribute("TileSize"));
    this.overlap = parseInt(img.getAttribute("Overlap"));
    this.format = img.getAttribute("Format") || "jpeg";
    this.width = parseInt(size.getAttribute("Width"));
    this.height = parseInt(size.getAttribute("Height"));
    this.maxLevel = Math.ceil(Math.log2(Math.max(this.width, this.height)));
    this.ready = true;
    return this;
  }
  levelDims(level) {
    const d = Math.pow(2, this.maxLevel - level);
    return [Math.max(1, Math.ceil(this.width / d)),
            Math.max(1, Math.ceil(this.height / d))];
  }
  tileUrl(level, col, row) {
    return `${this.baseUrl}_files/${level}/${col}_${row}.${this.format}`;
  }
}

class DPAIViewer {
  constructor(containerId, sources) {
    this.container = document.getElementById(containerId);
    this.container.style.position = "relative";
    this.container.style.overflow = "hidden";
    this.container.style.background = "#111";
    this.sources = sources.map((s) => ({
      src: new DZSource(s.url),
      opacity: s.opacity === undefined ? 1.0 : s.opacity,
      world: null, levels: {},
    }));
    this.tx = 0; this.ty = 0; this.scale = 0.001; // screen px per level-0 px
    this._bindEvents();
  }

  async init() {
    for (const layer of this.sources) {
      try { await layer.src.load(); } catch (e) { layer.failed = true; continue; }
      const world = document.createElement("div");
      world.style.position = "absolute";
      world.style.transformOrigin = "0 0";
      world.style.opacity = layer.opacity;
      this.container.appendChild(world);
      layer.world = world;
    }
    const base = this.sources[0].src;
    const cw = this.container.clientWidth, ch = this.container.clientHeight;
    this.scale = Math.min(cw / base.width, ch / base.height) * 0.95;
    this.minScale = this.scale * 0.5;
    this.tx = (cw - base.width * this.scale) / 2;
    this.ty = (ch - base.height * this.scale) / 2;
    this.render();
  }

  setOpacity(i, v) {
    const layer = this.sources[i];
    layer.opacity = v;
    if (layer.world) layer.world.style.opacity = v;
  }

  _bindEvents() {
    let dragging = false, lx = 0, ly = 0;
    const el = this.container;
    el.addEventListener("mousedown", (e) => { dragging = true; lx = e.clientX; ly = e.clientY; });
    window.addEventListener("mouseup", () => { dragging = false; });
    window.addEventListener("mousemove", (e) => {
      if (!dragging) return;
      this.tx += e.clientX - lx; this.ty += e.clientY - ly;
      lx = e.clientX; ly = e.clientY;
      this.render();
    });
    el.addEventListener("wheel", (e) => {
      e.preventDefault();
      const rect = el.getBoundingClientRect();
      const mx = e.clientX - rect.left, my = e.clientY - rect.top;
      const factor = Math.pow(1.0015, -e.deltaY);
      const ns = Math.min(Math.max(this.scale * factor, this.minScale), 8);
      // zoom about the cursor
      this.tx = mx - (mx - this.tx) * (ns / this.scale);
      this.ty = my - (my - this.ty) * (ns / this.scale);
      this.scale = ns;
      this.render();
    }, { passive: false });
    window.addEventListener("resize", () => this.render());
  }

  _levelFor(src) {
    const ideal = src.maxLevel + Math.log2(this.scale);
    return Math.max(0, Math.min(src.maxLevel, Math.ceil(ideal)));
  }

  render() {
    const cw = this.container.clientWidth, ch = this.container.clientHeight;
    for (const layer of this.sources) {
      if (!layer.world) continue;
      const src = layer.src;
      layer.world.style.transform =
        `translate(${this.tx}px, ${this.ty}px) scale(${this.scale})`;
      const level = this._levelFor(src);
      const f = Math.pow(2, src.maxLevel - level); // level-0 px per dz px
      const [lw, lh] = src.levelDims(level);
      const t = src.tileSize;
      // visible range in dz-level pixels
      const vx0 = Math.max(0, Math.floor((-this.tx / this.scale) / f));
      const vy0 = Math.max(0, Math.floor((-this.ty / this.scale) / f));
      const vx1 = Math.min(lw, Math.ceil(((cw - this.tx) / this.scale) / f));
      const vy1 = Math.min(lh, Math.ceil(((ch - this.ty) / this.scale) / f));
      if (!layer.levels[level]) {
        const div = document.createElement("div");
        div.style.position = "absolute";
        layer.world.appendChild(div);
        layer.levels[level] = { div: div, tiles: {} };
      }
      for (const [l, entry] of Object.entries(layer.levels)) {
        entry.div.style.display = (parseInt(l) <= level) ? "" : "none";
      }
      const entry = layer.levels[level];
      const c0 = Math.floor(vx0 / t), c1 = Math.floor(Math.max(vx0, vx1 - 1) / t);
      const r0 = Math.floor(vy0 / t), r1 = Math.floor(Math.max(vy0, vy1 - 1) / t);
      for (let r = r0; r <= r1; r++) {
        for (let c = c0; c <= c1; c++) {
          const key = c + "_" + r;
          if (entry.tiles[key]) continue;
          const img = document.createElement("img");
          const ox = c > 0 ? src.overlap : 0, oy = r > 0 ? src.overlap : 0;
          img.src = src.tileUrl(level, c, r);
          img.style.position = "absolute";
          img.style.left = (c * t - ox) * f + "px";
          img.style.top = (r * t - oy) * f + "px";
          img.style.imageRendering = this.scale * f > 4 ? "pixelated" : "auto";
          img.onload = () => {
            img.style.width = img.naturalWidth * f + "px";
            img.style.height = img.naturalHeight * f + "px";
          };
          img.draggable = false;
          entry.div.appendChild(img);
          entry.tiles[key] = img;
        }
      }
    }
    this._updateScalebar();
  }

  _updateScalebar() {
    const el = document.getElementById("dpai-scalebar");
    if (!el || !this.mpp) { if (el) el.style.display = "none"; return; }
    const targetPx = 120; // aim for ~120 screen px
    const microns = targetPx / this.scale * this.mpp;
    const nice = Math.pow(10, Math.floor(Math.log10(microns)));
    const m = microns / nice >= 5 ? 5 * nice : microns / nice >= 2 ? 2 * nice : nice;
    el.style.display = "";
    el.style.width = (m / this.mpp) * this.scale + "px";
    el.textContent = m >= 1000 ? (m / 1000) + " mm" : m + " µm";
  }
}

window.DPAIViewer = DPAIViewer;
