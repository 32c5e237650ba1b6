"""Configuration: the port's own copies of the reference package's
jax-free config modules (defaults, XML reader, unit conversion)."""

from . import defaults
from .units import Parameters
from .xmlconfig import Config, ConfigNode

__all__ = ["defaults", "Parameters", "Config", "ConfigNode"]
