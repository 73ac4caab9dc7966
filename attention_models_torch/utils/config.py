"""YAML config with attribute access, dotted CLI overrides and ``${a.b.c}``
interpolation.

The port's own copy of ``attention_models_tpu/utils/config.py`` (same
schema, same semantics). PyYAML is imported only where YAML is parsed, so a
config built from a dict needs no YAML at all.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Mapping

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(Mapping):
    """Nested attribute-access dict. Missing keys raise AttributeError at the
    access site."""

    def __init__(self, data: dict | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", _root)
        for k, v in (data or {}).items():
            self._data[k] = self._wrap(v)

    def _wrap(self, v: Any) -> Any:
        if isinstance(v, Config):
            object.__setattr__(v, "_root", self._root_cfg())
            return v
        if isinstance(v, dict):
            return Config(v, _root=self._root_cfg())
        if isinstance(v, list):
            return [self._wrap(x) for x in v]
        return v

    def _root_cfg(self) -> "Config":
        return self._root if self._root is not None else self

    def _resolve(self, v: Any) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v)
            if m:  # whole-string interpolation keeps the referenced type
                return self._root_cfg().get_path(m.group(1))
            if _INTERP_RE.search(v):
                return _INTERP_RE.sub(
                    lambda m: str(self._root_cfg().get_path(m.group(1))), v
                )
        if isinstance(v, list):
            return [self._resolve(x) for x in v]
        return v

    def get_path(self, dotted: str) -> Any:
        node: Any = self._root_cfg()
        for part in dotted.split("."):
            if not isinstance(node, Config):
                raise KeyError(f"cannot resolve '{dotted}': '{part}' not a "
                               f"mapping")
            node = node[part]
        return node

    def __getitem__(self, key: str) -> Any:
        return self._resolve(self._data[key])

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"config has no key '{key}'") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def to_dict(self) -> dict:
        """Plain nested dict with every interpolation resolved."""
        out = {}
        for k in self._data:
            v = self[k]
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x
                          for x in v]
            else:
                out[k] = v
        return out

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node._data or not isinstance(node._data[p], Config):
                node._data[p] = Config({}, _root=self._root_cfg())
            node = node._data[p]
        node._data[parts[-1]] = node._wrap(value)

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _parse_value(s: str) -> Any:
    """A CLI override value with YAML scalar semantics (``a.b=3`` is an
    int, ``x=null`` is None, ``y=[1,2]`` a list)."""
    import yaml

    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config(data)


def config_from_cli(argv: list[str]) -> Config:
    """A config from ``--config=<yaml>`` (or ``config=<yaml>``) plus dotted
    ``key.path=value`` overrides."""
    overrides: dict[str, Any] = {}
    cfg_path = None
    for arg in argv:
        if "=" not in arg:
            continue
        key, _, val = arg.partition("=")
        key = key.lstrip("-")
        if key == "config":
            cfg_path = val
        else:
            overrides[key] = _parse_value(val)
    if cfg_path is None:
        raise ValueError("missing --config=<yaml> argument")
    cfg = load_config(cfg_path)
    for dotted, val in overrides.items():
        cfg.set_path(dotted, val)
    return cfg
