"""XML configuration reader, schema-compatible with the reference HemoCell.

The reference uses a tinyxml2-backed ``Config`` wrapper with typed ``read<T>()``
accessors (reference: config/config.h:37-75).  Here the same XML schema
(``config.xml`` per case plus one material XML per cell type, e.g.
``RBC.xml``) is parsed with the standard library so that unmodified reference
case files run unchanged.

Access mirrors the reference's chained-bracket style::

    cfg = Config("config.xml")
    dx = cfg["domain"]["dx"].read(float)
    nmax = cfg["sim"]["tmax"].read(int)

Missing keys raise ``KeyError`` (the reference throws
``std::invalid_argument``); callers use ``.get(...)`` helpers for optional
values.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Any


class ConfigNode:
    """One XML element; supports chained indexing and typed reads."""

    def __init__(self, element: ET.Element, path: str = ""):
        self._el = element
        self._path = path

    def __getitem__(self, name: str) -> "ConfigNode":
        child = self._el.find(name)
        if child is None:
            raise KeyError(f"Config key not found: {self._path}/{name}")
        return ConfigNode(child, f"{self._path}/{name}")

    def __contains__(self, name: str) -> bool:
        return self._el.find(name) is not None

    def read(self, typ: type = str) -> Any:
        text = (self._el.text or "").strip()
        if typ is bool:
            return text.strip() not in ("0", "false", "False", "")
        if typ is str:
            return text
        return typ(text)

    def get(self, name: str, typ: type = str, default: Any = None) -> Any:
        """Optional read: default when the key is absent."""
        child = self._el.find(name)
        if child is None:
            return default
        return ConfigNode(child, f"{self._path}/{name}").read(typ)


class Config(ConfigNode):
    """Root config document.

    Like the reference (config/config.h:58-75), the root element
    (``<hemocell>`` or ``<checkpoint>``) is transparent: indexing starts below
    it.  A root tag of ``checkpoint`` flags a resumed run
    (reference: core/hemoCell.cpp:84-88).
    """

    def __init__(self, path: str):
        tree = ET.parse(path)
        root = tree.getroot()
        super().__init__(root, path)
        self.path = path
        self.directory = os.path.dirname(os.path.abspath(path))
        self.checkpointed = root.tag == "checkpoint"

