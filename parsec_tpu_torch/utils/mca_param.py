"""MCA-style runtime parameter system.

Mirrors the reference's Modular Component Architecture parameter registry
(parsec/utils/mca_param.c, ~2000 LoC): parameters are registered by
(framework, component, name), and values are resolved with priority

    explicit set()  >  environment PARSEC_MCA_<name>  >  config file  >
    registered default

Config files: ``~/.parsec/mca-params.conf`` and ``$PARSEC_MCA_PARAM_FILES``
(``key = value`` lines, ``#`` comments), matching the reference's file
search (mca_param.c file parsing).

The reference dumps all parameters on --help (parsec.c:903-918); here
:func:`dump` returns the same information programmatically.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

ENV_PREFIX = "PARSEC_MCA_"


@dataclass
class _Param:
    name: str                      # full dotted name, e.g. "sched.lfq.steal_depth"
    default: Any
    type: type
    help: str = ""
    read_only: bool = False
    # closed value set (reference: mca_base_var enum registration) —
    # resolution validates against it so a typo'd env var / set() fails
    # loudly instead of silently meaning "default"
    choices: Optional[tuple] = None
    # explicit runtime override (set()); highest priority
    override: Any = None
    has_override: bool = False

    def _validate(self, value: Any, source: str) -> Any:
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"MCA param {self.name}: invalid value {value!r} (from "
                f"{source}); choices are {', '.join(map(str, self.choices))}")
        return value

    def resolve(self, file_values: Dict[str, str]) -> Any:
        if self.has_override:
            return self._validate(self.override, "set()")
        env_key = ENV_PREFIX + self.name.replace(".", "_")
        if env_key in os.environ:
            return self._validate(_coerce(os.environ[env_key], self.type),
                                  f"env {env_key}")
        if self.name in file_values:
            return self._validate(_coerce(file_values[self.name], self.type),
                                  "config file")
        return self.default


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return str(value).strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(str(value).strip(), 0)
    if typ is float:
        return float(value)
    return value


class ParamRegistry:
    def __init__(self) -> None:
        self._params: Dict[str, _Param] = {}
        self._file_values: Dict[str, str] = {}
        self._files_loaded = False
        self._lock = threading.Lock()
        self._generation = 0
        self._cache: Dict[str, tuple] = {}   # name -> (generation, value)

    # -- file layer -------------------------------------------------------
    def _load_files(self) -> None:
        if self._files_loaded:
            return
        self._files_loaded = True
        paths: List[str] = []
        home = os.path.expanduser("~/.parsec/mca-params.conf")
        paths.append(home)
        extra = os.environ.get("PARSEC_MCA_PARAM_FILES", "")
        paths.extend(p for p in extra.split(os.pathsep) if p)
        for path in paths:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.split("#", 1)[0].strip()
                        if not line or "=" not in line:
                            continue
                        key, val = line.split("=", 1)
                        self._file_values[key.strip()] = val.strip()
            except OSError:
                continue

    # -- registration / access -------------------------------------------
    def register(self, name: str, default: Any, help: str = "",
                 type: Optional[type] = None, read_only: bool = False,
                 choices: Optional[tuple] = None) -> None:
        with self._lock:
            if name in self._params:
                return
            typ = type if type is not None else (default.__class__ if default is not None else str)
            self._params[name] = _Param(name=name, default=default, type=typ,
                                        help=help, read_only=read_only,
                                        choices=tuple(choices) if choices
                                        else None)

    def get(self, name: str, default: Any = None) -> Any:
        self._load_files()
        with self._lock:
            p = self._params.get(name)
            if p is None:
                # unregistered lookups still honor env/file so components can
                # probe without registering first
                env_key = ENV_PREFIX + name.replace(".", "_")
                if env_key in os.environ:
                    raw = os.environ[env_key]
                    return _coerce(raw, default.__class__) if default is not None else raw
                if name in self._file_values:
                    raw = self._file_values[name]
                    return _coerce(raw, default.__class__) if default is not None else raw
                return default
            return p.resolve(self._file_values)

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            p = self._params.get(name)
            if p is None:
                p = _Param(name=name, default=None, type=value.__class__)
                self._params[name] = p
            if p.read_only:
                raise ValueError(f"MCA param {name} is read-only")
            p.override = value
            p.has_override = True
            self._generation += 1

    def unset(self, name: str) -> None:
        with self._lock:
            p = self._params.get(name)
            if p is not None:
                p.override, p.has_override = None, False
                self._generation += 1

    def override_of(self, name: str) -> tuple:
        """``(has_override, value)`` — the runtime-override layer only
        (env/file/default layers are process-fixed). The save half of a
        save/restore pair for harnesses that must pin knobs temporarily
        inside a LIVE process (see :meth:`restore_override`): plain
        unset() would destroy a caller's explicit pin."""
        with self._lock:
            p = self._params.get(name)
            if p is None or not p.has_override:
                return (False, None)
            return (True, p.override)

    def restore_override(self, name: str, saved: tuple) -> None:
        """Restore a knob to its :meth:`override_of` snapshot."""
        had, value = saved
        if had:
            self.set(name, value)
        else:
            self.unset(name)

    def generation(self) -> int:
        """Monotonic counter bumped by set()/unset(): hot paths cache a
        resolved value keyed by this instead of re-resolving per call
        (env/file layers are fixed after startup; runtime overrides are
        the only mid-process change channel)."""
        return self._generation

    def cached_get(self, name: str, default: Any = None) -> Any:
        """``get`` memoized by :meth:`generation` — for per-message hot
        paths (a full ``get`` resolves env vars per call, ~3 µs; this is
        a dict hit + one int compare). Unlocked by design: a racing
        ``set`` at worst causes one redundant re-resolve.

        Env-var caveat (intended): the generation counter only bumps on
        ``set()``/``unset()``, so an IN-PROCESS ``os.environ`` change
        (e.g. mutating ``PARSEC_MCA_comm_eager_limit`` after startup)
        that a plain :meth:`get` would honor is NOT seen here until the
        next ``set()``/``unset()`` of ANY param. Change parameters at
        runtime through ``set()`` — that is what the runtime and every
        test do; env vars are a process-startup channel."""
        gen = self._generation
        hit = self._cache.get(name)
        if hit is not None and hit[0] == gen:
            return hit[1]
        val = self.get(name, default)
        self._cache[name] = (gen, val)
        return val

    def dump(self) -> List[Dict[str, Any]]:
        """All registered params with current values (parsec --help analog)."""
        self._load_files()
        with self._lock:
            return [
                {"name": p.name, "value": p.resolve(self._file_values),
                 "default": p.default, "help": p.help}
                for p in sorted(self._params.values(), key=lambda p: p.name)
            ]


_registry = ParamRegistry()

register = _registry.register
get = _registry.get
set = _registry.set
unset = _registry.unset
override_of = _registry.override_of
restore_override = _registry.restore_override
dump = _registry.dump
generation = _registry.generation
cached_get = _registry.cached_get


def parse_cli(argv: List[str]) -> List[str]:
    """Consume ``--mca key value`` pairs from argv (parsec.c:411-463 analog).

    Returns argv with the consumed arguments removed.
    """
    out: List[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "--mca" and i + 2 < len(argv):
            _registry.set(argv[i + 1], argv[i + 2])
            i += 3
        else:
            out.append(argv[i])
            i += 1
    return out
