from . import gapfill, voting, windows
