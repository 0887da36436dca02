"""Searchers by name: ``<name>.py`` holds ``build(cfg, patterns,
device)``, the program's searcher over a configuration's patterns. A
configuration names its searcher (``searcher``); a new kind of searcher
is a new file here."""
