# ``beam_search`` is the submodule here (the function is
# ``beam_search.beam_search``): tests and callers import it as a module.
from .beam_search import BeamDecoder, greedy_decode
from .guided import guided_hook_builder

__all__ = ["BeamDecoder", "greedy_decode", "guided_hook_builder"]
