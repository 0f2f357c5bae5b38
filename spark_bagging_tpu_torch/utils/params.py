"""sklearn-compatible params protocol: ``get_params``/``set_params``/``clone``
over the ``__init__`` keyword signature (a copy of the JAX package's
``utils/params.py``; the port imports nothing of that package)."""

from __future__ import annotations

import inspect
from typing import Any


class ParamsMixin:
    """``get_params``/``set_params``/``clone`` over the ``__init__`` signature.

    Subclasses must store every ``__init__`` keyword verbatim as an
    attribute of the same name (sklearn's convention).
    """

    @classmethod
    def _param_names(cls) -> list[str]:
        sig = inspect.signature(cls.__init__)
        return [
            name
            for name, p in sig.parameters.items()
            if name != "self"
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name in self._param_names():
            value = getattr(self, name)
            out[name] = value
            # a CLASS passed as a param exposes an unbound get_params
            if (deep and hasattr(value, "get_params")
                    and not isinstance(value, type)):
                for sub, sub_val in value.get_params(deep=True).items():
                    out[f"{name}__{sub}"] = sub_val
        return out

    def set_params(self, **params: Any):
        if not params:
            return self
        valid = set(self._param_names())
        nested: dict[str, dict[str, Any]] = {}
        for key, value in params.items():
            name, _, sub = key.partition("__")
            if name not in valid:
                raise ValueError(
                    f"Invalid parameter {name!r} for {type(self).__name__}. "
                    f"Valid parameters: {sorted(valid)}"
                )
            if sub:
                nested.setdefault(name, {})[sub] = value
            else:
                setattr(self, name, value)
        for name, sub_params in nested.items():
            getattr(self, name).set_params(**sub_params)
        return self

    def clone(self):
        """Unfitted copy with the same params (sklearn ``clone`` semantics)."""
        params = {
            name: (value.clone() if hasattr(value, "clone") else value)
            for name, value in self.get_params(deep=False).items()
        }
        return type(self)(**params)

    def __repr__(self) -> str:
        """sklearn-style repr: only params that differ from their
        ``__init__`` defaults are shown."""
        defaults = {
            name: p.default
            for name, p in inspect.signature(
                type(self).__init__
            ).parameters.items()
            if p.default is not inspect.Parameter.empty
        }
        shown = []
        for name in self._param_names():
            value = getattr(self, name)
            default = defaults.get(name, inspect.Parameter.empty)
            try:
                is_default = (value == default) is True
            except Exception:  # noqa: BLE001 — uncomparable values print
                is_default = False
            if not is_default:
                shown.append(f"{name}={value!r}")
        return f"{type(self).__name__}({', '.join(shown)})"
