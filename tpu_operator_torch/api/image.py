"""Image path resolution (the port's own copy of ``tpu_operator/api/image.py``).

repository + image + version -> "repo/image:version" (or "repo/image@sha256:..."
for digests); falls back to a per-component env var (e.g. GPU_DRIVER_IMAGE)
exactly like the NVIDIA operator resolves *_IMAGE defaults.
"""

from __future__ import annotations

import os
import re
from typing import Optional

_ENV_SAFE = re.compile(r"[^A-Z0-9]+")


def env_var_for(component: str) -> str:
    return _ENV_SAFE.sub("_", component.upper()) + "_IMAGE"


def image_path(component: str, repository: Optional[str], image: Optional[str],
               version: Optional[str]) -> str:
    """Resolve the full image path for an operand.

    Raises ValueError when neither spec fields nor the env fallback resolve —
    the same hard failure the reference produces for unresolvable images.
    """
    if image and "/" in image and (":" in image.split("/")[-1] or "@" in image):
        return image  # fully-qualified already
    if repository and image and version:
        sep = "@" if version.startswith("sha256:") else ":"
        return f"{repository}/{image}{sep}{version}"
    env = os.environ.get(env_var_for(component))
    if env:
        return env
    raise ValueError(
        f"cannot resolve image for {component!r}: need repository+image+version "
        f"or ${env_var_for(component)}")
