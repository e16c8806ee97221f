"""Test suite (a regular package, so ``tests.conftest`` resolves here
and not to another ``tests`` package on the path)."""
