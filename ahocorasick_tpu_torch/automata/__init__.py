from .dfa import DenseDFA, build_dfa  # noqa: F401
from .noncontiguous import NFA, compile_nfa  # noqa: F401
