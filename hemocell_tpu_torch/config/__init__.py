"""Configuration: the port's own copies of the reference package's
jax-free config modules (defaults, XML reader, unit conversion)."""

from . import defaults
from .units import Parameters
from .xmlconfig import Config, ConfigNode, load_directories

__all__ = ["defaults", "Parameters", "Config", "ConfigNode", "load_directories"]
