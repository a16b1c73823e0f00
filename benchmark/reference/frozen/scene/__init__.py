# Package marker of the frozen copy (see ../__init__.py).
