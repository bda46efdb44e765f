"""Calibration YAML readers for both dialects used by the reference.

1. The X-maps dialect (reference: cam_proj_calibration.py:17-28,77-108):
   plain YAML where each matrix is a mapping with ``type-id: opencv_matrix``,
   ``rows``, ``cols``, ``data``.
2. The ESL dialect (reference: cam_proj_calibration.py:110-140): an OpenCV
   FileStorage YAML (``%YAML:1.0`` header, ``!!opencv-matrix`` tags) with
   keys cam_K, cam_kc, proj_K, proj_kc, R, T.  The reference reads it with
   cv2.FileStorage; we parse it standalone.

Both are read by a small parser for the YAML subset calibration files
use: block mappings by indentation, block sequences of scalars, flow
sequences and mappings (which may span lines), plain and quoted scalars,
comments, directives and node tags (tags are dropped, so a tagged
``!!opencv-matrix`` becomes a plain mapping).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["load_cv_yaml", "parse_cv_yaml", "read_cv_matrix"]

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(
    r"[-+]?(\d+\.?\d*([eE][-+]?\d+)?|\.\d+([eE][-+]?\d+)?|\d+[eE][-+]?\d+)$"
)
_SPECIAL = {
    ".nan": float("nan"), ".inf": float("inf"), "+.inf": float("inf"),
    "-.inf": float("-inf"), "true": True, "false": False,
    "null": None, "~": None,
}


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return _SPECIAL.get(text.lower(), text) if text else None


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _drop_tag(text: str) -> str:
    text = text.strip()
    if text.startswith("!"):
        parts = text.split(None, 1)
        return parts[1] if len(parts) > 1 else ""
    return text


def _flow(text: str, i: int = 0):
    """Parse one flow node starting at text[i]; returns (value, end)."""
    while text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        items, i = [], i + 1
        while True:
            while text[i] in " ,":
                i += 1
            if text[i] == close:
                break
            if close == "]":
                v, i = _flow(text, i)
                items.append(v)
            else:
                j = text.index(":", i)
                key = _scalar(text[i:j])
                v, i = _flow(text, j + 1)
                items.append((key, v))
        return (items if close == "]" else dict(items)), i + 1
    j = i
    while j < len(text) and text[j] not in ",]}":
        j += 1
    return _scalar(_drop_tag(text[i:j])), j


def _value(text: str):
    text = _drop_tag(text)
    if text[:1] in ("[", "{"):
        return _flow(text)[0]
    return _scalar(text)


def _block(lines: list, i: int, indent: int):
    """Parse the block node whose lines start at lines[i] with this
    indent; returns (value, next line index)."""
    if lines[i][1].startswith("-"):
        out = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
            rest = lines[i][1][1:].strip()
            i += 1
            if rest:
                out.append(_value(rest))
            elif i < len(lines) and lines[i][0] > indent:
                v, i = _block(lines, i, lines[i][0])
                out.append(v)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        m = re.match(r"""("[^"]*"|'[^']*'|[^:]+?)\s*:(\s|$)""", text)
        if not m:
            raise ValueError(f"calibration YAML: cannot parse line {text!r}")
        key = _scalar(m.group(1))
        rest = _drop_tag(text[m.end():])
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (
            lines[i][0] > indent
            or (lines[i][0] == indent and lines[i][1].startswith("-"))
        ):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"calibration YAML: bad indentation at {lines[i][1]!r}")
    return out, i


def parse_cv_yaml(text: str) -> dict:
    """Parse calibration YAML text of either dialect into plain Python
    values (dicts, lists, int, float, str)."""
    lines = []
    pending = None  # a flow collection continued over several lines
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending[1] += " " + line.strip()
            if pending[1].count("[") + pending[1].count("{") <= (
                pending[1].count("]") + pending[1].count("}")
            ):
                lines.append(tuple(pending))
                pending = None
            continue
        if not line.strip() or line.startswith("%") or line.strip() == "---":
            continue
        entry = [len(line) - len(line.lstrip(" ")), line.strip()]
        if entry[1].count("[") + entry[1].count("{") > (
            entry[1].count("]") + entry[1].count("}")
        ):
            pending = entry
        else:
            lines.append(tuple(entry))
    if pending is not None:
        raise ValueError("calibration YAML: unterminated flow collection")
    if not lines:
        return {}
    out, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"calibration YAML: unexpected line {lines[i][1]!r}")
    return out


def load_cv_yaml(path: str) -> dict:
    """Load a calibration YAML file of either dialect into a plain dict.

    Handles the OpenCV FileStorage quirks: the ``%YAML:1.0`` directive and
    ``!!opencv-matrix`` tags (converted to plain mappings).
    """
    with open(path, "r") as f:
        return parse_cv_yaml(f.read())


def read_cv_matrix(calibration_data: dict, name: str) -> np.ndarray:
    """Read an OpenCV-style matrix entry from a parsed calibration dict.

    Accepts both the explicit ``type-id: opencv_matrix`` form of the X-maps
    dialect (reference: cam_proj_calibration.py:17-28) and the tagged
    FileStorage form (where the tag was already erased by the loader).
    """
    entry = calibration_data.get(name)
    if (
        isinstance(entry, dict)
        and "rows" in entry
        and "cols" in entry
        and "data" in entry
        and (entry.get("type-id", "opencv_matrix") == "opencv_matrix")
    ):
        return np.array(entry["data"], dtype=np.float64).reshape(
            entry["rows"], entry["cols"]
        )
    raise ValueError(f"Could not read matrix {name} from calibration data")
