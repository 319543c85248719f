from .engine import MissingKeyError, Template, TemplateError, render_string  # noqa: F401
from .renderer import Renderer  # noqa: F401
