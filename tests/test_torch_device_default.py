"""mxx_tpu_torch computes on the card unless the caller asks for the CPU: no
function, method or constructor of the package defaults a `device`
parameter to the CPU. (The CPU tests pass device="cpu" themselves.)"""

import importlib
import inspect
import pkgutil

import torch

import mxx_tpu_torch


def _callables():
    """(qualified name, function) for every function, method and
    constructor defined in a module of the package."""
    for info in pkgutil.walk_packages(mxx_tpu_torch.__path__, "mxx_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if getattr(obj, "__module__", None) != module.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{module.__name__}.{name}", obj
            elif inspect.isclass(obj):
                for attr, value in vars(obj).items():
                    fn = value.__func__ if isinstance(value, (staticmethod, classmethod)) else value
                    if inspect.isfunction(fn):
                        yield f"{module.__name__}.{name}.{attr}", fn


def _is_cpu(default) -> bool:
    try:
        return torch.device(default).type == "cpu"
    except (TypeError, RuntimeError):
        return False


def test_no_device_parameter_defaults_to_the_cpu():
    found = []
    with_device = 0
    for qualname, fn in _callables():
        param = inspect.signature(fn).parameters.get("device")
        if param is None or param.default is inspect.Parameter.empty:
            continue
        with_device += 1
        if _is_cpu(param.default):
            found.append(f"{qualname}: device={param.default!r}")
    assert with_device >= 38, with_device  # the walk reached the package's entry points
    assert not found, "device parameters that default to the CPU:\n" + "\n".join(found)
