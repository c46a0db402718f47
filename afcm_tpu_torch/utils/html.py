"""Static HTML result gallery (reference: util/html.py, minus the dominate
dependency — plain string templating).

The port's own copy of ``afcm_tpu/utils/html.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self._body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str):
        self._body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 400):
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td style='text-align:center'>"
                f"<a href='images/{_html.escape(link)}'>"
                f"<img style='width:{width}px' src='images/{_html.escape(im)}'>"
                f"</a><br><p>{_html.escape(str(txt))}</p></td>")
        self._body.append("<table border='1' style='border-collapse:collapse'>"
                          f"<tr>{''.join(cells)}</tr></table>")

    def save(self):
        refresh = (f"<meta http-equiv='refresh' content='{self.refresh}'>"
                   if self.refresh > 0 else "")
        doc = (f"<!DOCTYPE html><html><head><title>"
               f"{_html.escape(self.title)}</title>{refresh}</head><body>"
               f"{''.join(self._body)}</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)
