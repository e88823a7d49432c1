from .registry import CHARACTERS, HEELED_CHARACTERS, Character, get_character
from . import defs
