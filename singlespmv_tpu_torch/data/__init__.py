"""The port's matrix data layer: copies of the reference's synthetic
generators (``data/generators.py``), structure-matched natural-suite
stand-ins (``data/structgen.py``), hand-checkable fixtures
(``data/fixtures.py``), the spy plot and structure metrics
(``data/tools.py``) and the suite's ``extract_mtx`` and ``synthesize``
(``data/suitesparse.py``); one name and seed give the same matrix in both
packages."""
from .fixtures import ALL_FIXTURES
from .generators import artificial_suite, generate, powerlaw
from .structgen import synthesize_structured

__all__ = ["ALL_FIXTURES", "artificial_suite", "generate", "powerlaw",
           "synthesize_structured"]
