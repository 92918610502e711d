"""The program's model configuration made from a configuration file's
``model`` section (the sizes as run)."""
from __future__ import annotations

import dataclasses
import typing


def model_config(cfg: dict):
    """``repro_torch``'s ``ModelConfig`` with the file's sizes.  A nested
    group becomes the dataclass its field is typed with (``moe``,
    ``hybrid.ssm``, ``encoder``, ``vlm``, whatever a later field adds),
    a list a tuple."""
    from repro_torch.configs import base

    return _make(base.ModelConfig, cfg)


def _dataclass_of(hint):
    """The dataclass a field holds (``X`` or ``Optional[X]``), or None."""
    for t in (hint, *typing.get_args(hint)):
        if dataclasses.is_dataclass(t):
            return t
    return None


def _make(cls, d: dict):
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no field {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        sub = _dataclass_of(hints[name])
        if isinstance(v, dict) and sub is not None:
            v = _make(sub, v)
        elif isinstance(v, list):
            v = _tuple(v)
        kw[name] = v
    return cls(**kw)


def _tuple(v):
    return tuple(_tuple(x) if isinstance(x, list) else x for x in v)


def as_dict(model_cfg) -> dict:
    """A ``ModelConfig`` back as a configuration file's ``model`` section."""
    return json_ready(dataclasses.asdict(model_cfg))


def json_ready(v):
    if isinstance(v, dict):
        return {k: json_ready(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_ready(x) for x in v]
    return v
