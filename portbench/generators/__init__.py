"""Generators by name: ``<name>.py`` holds ``patterns(spec)`` (a
configuration's pattern set) or ``pool(spec, patterns, size, count,
seed)`` (a workload's haystacks). The harness loads the one a file names;
a new generator is a new file here."""
