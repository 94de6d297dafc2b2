"""Gluon model zoo (the ported ResNet family)."""
from . import vision
from .vision import get_model
