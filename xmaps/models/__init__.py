"""Flagship end-to-end models built from the ops layer."""

from xmaps.models.depth_pipeline import XMapsDepthEngine  # noqa: F401
