"""Policy registry: ``register("name", factory)`` / ``resolve("name?k=v")``.

Counterpart of ``repro.sched.registry``. ``resolve`` accepts a bare name
or a query-string spec (``"dada?alpha=0.25&use_cp=1"``) and coerces every
query value to the type the factory's signature declares — ``alpha=0.25``
arrives as a float, ``use_cp=1`` as a bool — so string specs construct
exactly the same objects as direct Python calls.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, factory: Optional[Callable] = None, *, overwrite: bool = False):
    """Register a policy factory (any callable returning a policy, e.g. a
    class) under ``name``; usable as a decorator (``@register("name")``).
    Re-registering a name raises unless ``overwrite=True``: silently
    shadowing a built-in policy is almost always a bug."""
    if factory is None:
        return lambda f: register(name, f, overwrite=overwrite)
    key = name.lower()
    if not overwrite and key in _REGISTRY:
        raise ValueError(
            f"policy {key!r} is already registered (pass overwrite=True to replace it)"
        )
    _REGISTRY[key] = factory
    return factory


def unregister(name: str) -> None:
    """Remove a registered policy (plugin teardown, tests)."""
    _REGISTRY.pop(name.lower(), None)


def registered() -> Tuple[str, ...]:
    """Registered policy names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_factory(name: str) -> Callable:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r} (registered: {', '.join(registered())})"
        ) from None


# ---------------------------------------------------------------------------
# typed query-string coercion

_BOOL_TRUE = ("1", "true", "yes", "on")
_BOOL_FALSE = ("0", "false", "no", "off")


def _coerce_bool(spec: str, key: str, value: str) -> bool:
    v = value.lower()
    if v in _BOOL_TRUE:
        return True
    if v in _BOOL_FALSE:
        return False
    raise ValueError(f"policy spec {spec!r}: {key}={value!r} is not a boolean")


def _coerce(spec: str, key: str, value: str, param: inspect.Parameter):
    """Coerce ``value`` to the type the factory declares for ``key``.

    Annotations are strings (``from __future__ import annotations``), so
    the mapping is by name; when no annotation helps, fall back to the
    default's type, then to int/float/str literal inference.
    """
    ann = param.annotation
    ann_name = ann if isinstance(ann, str) else getattr(ann, "__name__", "")
    ann_name = (ann_name or "").replace("Optional[", "").rstrip("]")
    if ann_name == "bool" or isinstance(param.default, bool):
        return _coerce_bool(spec, key, value)
    if ann_name == "int" or (
        param.default is not inspect.Parameter.empty
        and isinstance(param.default, int)
        and not isinstance(param.default, bool)
    ):
        try:
            return int(value)
        except ValueError:
            raise ValueError(
                f"policy spec {spec!r}: {key}={value!r} is not an integer"
            ) from None
    if ann_name == "float" or isinstance(param.default, float):
        try:
            return float(value)
        except ValueError:
            raise ValueError(
                f"policy spec {spec!r}: {key}={value!r} is not a number"
            ) from None
    if ann_name == "str" or isinstance(param.default, str):
        return value
    # untyped: best-effort literal inference
    for conv in (int, float):
        try:
            return conv(value)
        except ValueError:
            pass
    return value


def parse_spec(spec: str) -> Tuple[str, Dict[str, str]]:
    """Split ``"name?k=v&k2=v2"`` into (name, raw query dict)."""
    parts = urlsplit(spec)
    name = (parts.path or "").strip().lower()
    if not name or parts.scheme or parts.netloc or parts.fragment:
        raise ValueError(f"malformed policy spec {spec!r} (expected 'name?k=v')")
    raw = {}
    for k, v in parse_qsl(parts.query, keep_blank_values=True):
        if k in raw:
            raise ValueError(f"policy spec {spec!r}: duplicate key {k!r}")
        raw[k] = v
    return name, raw


def resolve(spec, **kwargs):
    """Build a policy from a spec string (or pass a policy through).

    ``resolve("dada?alpha=0.25&use_cp=1")`` == ``DADA(alpha=0.25,
    use_cp=True)``. Extra ``kwargs`` (e.g. ``device="cpu"``) merge with,
    and take precedence over, the query string. A non-string ``spec`` is
    returned unchanged.
    """
    if not isinstance(spec, str):
        return spec
    name, raw = parse_spec(spec)
    factory = get_factory(name)
    params = inspect.signature(factory).parameters
    has_var_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )
    call_kw = {}
    for k, v in raw.items():
        p = params.get(k)
        if p is None and not has_var_kw:
            known = ", ".join(
                n for n, q in params.items()
                if q.kind
                in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.KEYWORD_ONLY)
            )
            raise ValueError(
                f"policy spec {spec!r}: unknown parameter {k!r} for "
                f"{name!r} (accepts: {known})"
            )
        call_kw[k] = _coerce(spec, k, v, p) if p is not None else v
    call_kw.update(kwargs)
    return factory(**call_kw)


def resolve_on(spec: str, device="cuda"):
    """Build ``spec`` for ``device``. The device goes only to a factory
    whose signature declares it: ``ws`` and ``random`` score nothing and
    take none."""
    params = inspect.signature(get_factory(parse_spec(spec)[0])).parameters
    return resolve(spec, device=device) if "device" in params else resolve(spec)
