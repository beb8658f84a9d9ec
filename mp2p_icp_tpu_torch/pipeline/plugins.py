"""User plugins: extend the YAML class registries with custom modules.

Port of ``mp2p_icp_tpu/pipeline/plugins.py`` (reference:
load_plugin.cpp:21-110 dlopens a user library whose static initialisers
register classes; ``icp_pipeline_from_yaml`` honours a top-level
``plugin:`` key, icp_pipeline_from_yaml.cpp:34-38). A plugin is a Python
module, by dotted name or ``.py`` path (a relative path is searched in the
colon-separated ``MP2P_ICP_TPU_PLUGIN_PATH``). It registers the port's
classes into the port's registries with ``register_*``, or in a
``mp2p_register(api)`` entry point that receives this module; the YAML
then names them like built-ins.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
from typing import Callable

_LOADED: dict = {}


def _registries():
    from mp2p_icp_tpu_torch.pipeline import yaml_loader

    return yaml_loader


def register_matcher(name: str, factory: Callable) -> None:
    """Register a factory ``params dict -> matcher`` under a YAML class name
    (with or without a ``namespace::`` prefix)."""
    _registries()._MATCHERS[name.split("::")[-1]] = factory


def register_solver(name: str, factory: Callable) -> None:
    _registries()._SOLVERS[name.split("::")[-1]] = factory


def register_quality(name: str, factory: Callable) -> None:
    _registries()._QUALITY[name.split("::")[-1]] = factory


def register_filter(name: str, factory: Callable) -> None:
    """Register a factory ``(params dict, variables=None) -> filter``."""
    _registries()._FILTERS[name.split("::")[-1]] = factory


def _search_paths():
    return [p for p in os.environ.get("MP2P_ICP_TPU_PLUGIN_PATH", "").split(":") if p]


def load_plugin(module: str) -> object:
    """Load a plugin by dotted module name or ``.py`` path (reference:
    load_plugin.cpp:70-110); once per name."""
    if module in _LOADED:
        return _LOADED[module]
    if module.endswith(".py"):
        path = module
        if not os.path.isabs(path) and not os.path.exists(path):
            path = next((os.path.join(d, path) for d in _search_paths()
                         if os.path.exists(os.path.join(d, path))), path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Plugin '{module}' not found (searched "
                                    f"MP2P_ICP_TPU_PLUGIN_PATH={_search_paths()})")
        name = "mp2p_icp_tpu_torch_plugin_" + os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    hook = getattr(mod, "mp2p_register", None)
    if callable(hook):
        hook(sys.modules[__name__])
    _LOADED[module] = mod
    return mod
