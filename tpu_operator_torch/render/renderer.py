"""Manifest directory renderer (the port's own copy of
``tpu_operator/render/renderer.py``; internal/render/render.go analog).

Renders every ``*.yaml`` template under a state's manifest directory with a
render-data mapping, then parses the output into unstructured objects.
Files are rendered in lexical order — manifests are numbered
(0100_service_account.yaml … 0500_daemonset.yaml) so ordering is the
deployment order, exactly like the reference's asset layout.
"""

from __future__ import annotations

import pathlib
from typing import Any, List

from .engine import Template, TemplateError


# per-directory template cache: a Renderer is constructed per state per
# reconcile, but the manifest files on disk rarely change — re-reading
# and re-parsing 3-8 templates per state per pass is steady wasted CPU.
# The fingerprint (name, mtime_ns, size) per file invalidates the entry
# the moment a template is edited, added, or removed, so tests that
# write temp manifest dirs (and operators live-edited in dev) stay
# correct. Templates are immutable after construction, so sharing the
# parsed list across Renderer instances is safe.
_TEMPLATE_CACHE: dict = {}


class Renderer:
    def __init__(self, manifests_dir: str | pathlib.Path):
        self.dir = pathlib.Path(manifests_dir)
        if not self.dir.is_dir():
            raise FileNotFoundError(f"manifest dir {self.dir} does not exist")
        paths = sorted(self.dir.glob("*.yaml"))
        fingerprint = tuple(
            (p.name, st.st_mtime_ns, st.st_size)
            for p in paths for st in (p.stat(),))
        # exposed so higher-level render memoization (state/operands.py)
        # can key rendered output on template content, not just data
        self.fingerprint = fingerprint
        cached = _TEMPLATE_CACHE.get(str(self.dir))
        if cached is not None and cached[0] == fingerprint:
            self._templates = cached[1]
        else:
            self._templates = [
                (p.name, Template(p.read_text(), name=str(p)))
                for p in paths
            ]
            _TEMPLATE_CACHE[str(self.dir)] = (fingerprint, self._templates)
        if not self._templates:
            raise FileNotFoundError(f"no *.yaml templates under {self.dir}")

    def render_objects(self, data: Any) -> List[dict]:
        """Render all templates -> list of parsed objects (empty docs are
        dropped, multi-doc files are split)."""
        import yaml

        objects: List[dict] = []
        for name, tmpl in self._templates:
            text = tmpl.render(data)
            try:
                docs = list(yaml.safe_load_all(text))
            except yaml.YAMLError as e:
                raise TemplateError(
                    f"{self.dir / name}: rendered invalid YAML: {e}\n"
                    f"--- rendered ---\n{text}") from e
            for doc in docs:
                if not doc:
                    continue
                if "kind" not in doc or "apiVersion" not in doc:
                    raise TemplateError(
                        f"{self.dir / name}: rendered object missing "
                        f"kind/apiVersion")
                objects.append(doc)
        return objects
