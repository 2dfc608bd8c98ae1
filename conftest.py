"""Repository-wide pytest set-up: the repository root heads PYTHONPATH, so
that scripts a test starts in a subprocess (``examples/*.py``, whose
``sys.path[0]`` is ``examples/``) import the packages of this checkout."""

import os

_ROOT = os.path.dirname(os.path.abspath(__file__))
_paths = os.environ.get("PYTHONPATH", "").split(os.pathsep)
if _ROOT not in _paths:
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in _paths if p])
