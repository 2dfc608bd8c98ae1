"""The program's fits, one module a model family (a configuration's ``family``): set-up as the program's own fit does it, then whole fits."""
