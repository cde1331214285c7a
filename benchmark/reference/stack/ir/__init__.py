from .program import IRProgram, Pass, QubitScoper, CoreScoper
from . import instructions
from . import passes
