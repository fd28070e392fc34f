"""Static HTML/JS media grid viewer: ``write_media_grid`` writes an
``index.html`` beside a folder of generated images or videos, browsed with
the keyboard (arrows, Escape) and a lightbox. ``.mp4`` / ``.webm`` entries
are muted thumbnails that preload their metadata and play in the lightbox.

The port's own copy of ``arcflow_tpu/ui/media_viewer/grid_tools.py`` (that
module imports no JAX, but the port imports nothing of the JAX package):
the same page, byte for byte.
"""

from __future__ import annotations

import html
import os
from typing import Optional, Sequence

VIDEO_EXTS = ('.mp4', '.webm')

_VIEWER_JS = """
(function () {
  const cells = Array.from(document.querySelectorAll('.cell img, .cell video'));
  const box = document.getElementById('lightbox');
  const boxImg = document.getElementById('lightbox-img');
  const boxVid = document.getElementById('lightbox-video');
  const caption = document.getElementById('lightbox-caption');
  let cur = -1;
  function show(i) {
    if (i < 0 || i >= cells.length) return;
    cur = i;
    const isVideo = cells[i].tagName === 'VIDEO';
    boxImg.style.display = isVideo ? 'none' : '';
    boxVid.style.display = isVideo ? '' : 'none';
    if (isVideo) { boxVid.src = cells[i].src; boxVid.play(); }
    else { boxVid.pause(); boxVid.removeAttribute('src'); boxImg.src = cells[i].src; }
    caption.textContent = (i + 1) + ' / ' + cells.length + ' — ' +
      (cells[i].dataset.name || '');
    box.style.display = 'flex';
  }
  function hide() {
    box.style.display = 'none'; cur = -1;
    boxVid.pause(); boxVid.removeAttribute('src');
  }
  cells.forEach((el, i) => el.addEventListener('click', () => show(i)));
  box.addEventListener('click', (e) => { if (e.target !== boxVid) hide(); });
  document.addEventListener('keydown', (e) => {
    if (cur < 0) return;
    if (e.key === 'Escape') hide();
    else if (e.key === 'ArrowRight') show(Math.min(cur + 1, cells.length - 1));
    else if (e.key === 'ArrowLeft') show(Math.max(cur - 1, 0));
  });
})();
"""

_CSS = """
body { background: #111; color: #ddd; font-family: sans-serif; margin: 1em; }
.grid { display: grid; grid-template-columns: repeat(auto-fill, minmax(220px, 1fr)); gap: 8px; }
.cell img, .cell video { width: 100%; border-radius: 4px; cursor: zoom-in; }
.cell .name { font-size: 11px; opacity: .7; overflow: hidden;
  text-overflow: ellipsis; white-space: nowrap; }
#lightbox { display: none; position: fixed; inset: 0; background: #000c;
  align-items: center; justify-content: center; flex-direction: column; }
#lightbox img, #lightbox video { max-width: 95vw; max-height: 90vh; }
#lightbox-caption { padding: .5em; font-size: 13px; }
"""


def _thumb(path: str, title: str) -> str:
    """One grid cell; video extensions get a muted metadata-preload <video>
    thumbnail (reference grid_tools.py:25-27), everything else an <img>."""
    p, t = html.escape(path), html.escape(title)
    if os.path.splitext(path)[-1].lower() in VIDEO_EXTS:
        media = f'<video src="{p}" data-name="{t}" preload="metadata" muted></video>'
    else:
        media = f'<img src="{p}" data-name="{t}" loading="lazy">'
    return f'<div class="cell">{media}<div class="name">{t}</div></div>'


def grid_html(image_paths: Sequence[str], titles: Optional[Sequence[str]] = None,
              page_title: str = 'ArcFlow samples') -> str:
    titles = titles or [os.path.basename(p) for p in image_paths]
    cells = '\n'.join(_thumb(p, t) for p, t in zip(image_paths, titles))
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(page_title)}</title><style>{_CSS}</style></head>
<body><h2>{html.escape(page_title)}</h2>
<div class="grid">{cells}</div>
<div id="lightbox"><img id="lightbox-img">\
<video id="lightbox-video" controls loop style="display:none"></video>\
<div id="lightbox-caption"></div></div>
<script>{_VIEWER_JS}</script></body></html>"""


def write_media_grid(out_dir: str, image_paths: Sequence[str],
                     titles: Optional[Sequence[str]] = None,
                     page_title: str = 'ArcFlow samples') -> str:
    path = os.path.join(out_dir, 'index.html')
    os.makedirs(out_dir, exist_ok=True)
    rel = [os.path.relpath(p, out_dir) for p in image_paths]
    with open(path, 'w', encoding='utf-8') as f:
        f.write(grid_html(rel, titles, page_title))
    return path
