"""Plugin framework and builtin plugins (the JAX package's ``plugins/``):
hook points, payload policies, execution modes, a manager configured from
YAML and from the ``plugin_bindings`` table, and the registry of builtin
kinds (``builtin``)."""

from .framework import (HookType, Plugin, PluginConfig, PluginManager, PluginMode,
                        PluginViolation)
from . import builtin  # noqa: E402,F401 - populates the builtin registry

__all__ = ["HookType", "PluginMode", "Plugin", "PluginConfig", "PluginManager",
           "PluginViolation"]
