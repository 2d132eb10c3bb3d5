"""Architecture configurations: port copy of ``repro.configs`` (pure
Python, unchanged), so ``get_arch``, ``smoke_config`` and ``archs.ALL`` are
the reference's."""
