from .particles import Particles
from .field import BoxField

__all__ = ["Particles", "BoxField"]
