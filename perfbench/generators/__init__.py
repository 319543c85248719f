"""The traffic generators, one module a traffic kind: each ``Generator`` is
handed a ``harness.Rank`` and gives ``setup``, ``batch``, ``end_to_end``,
``facts``, ``release``, ``notes``, ``check`` and ``control``."""
