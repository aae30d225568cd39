"""Serving: the decode engine (:mod:`repro_torch.serve.engine`) and the
traffic-driven simulator (:mod:`repro_torch.serve.sim`,
:mod:`repro_torch.serve.trace`).

The simulator half is imported by the DSE, whose import chain stays clear
of the models and kernels, so the engine's symbols are resolved lazily
(PEP 562), as in the reference's package.
"""

_ENGINE_SYMBOLS = ("ServeConfig", "build_serve_step", "decode_state_shapes",
                   "generate")

__all__ = [*_ENGINE_SYMBOLS]


def __getattr__(name: str):
    if name in _ENGINE_SYMBOLS:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
