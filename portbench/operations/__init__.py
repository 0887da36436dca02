"""Operations by name: ``<name>.py`` says how a call is made and its
result consumed (``consumer(searcher)``), what the check keeps of it
(``keep``), the reference's answer (``expected(reference, haystack)``),
the gap between the two (``gap``, 0 where equal) and the matches an
answer holds (``matches``). A new operation is a new file here."""
