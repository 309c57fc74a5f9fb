from .modulus import Modulus, Modulus32, Modulus64
from . import host
