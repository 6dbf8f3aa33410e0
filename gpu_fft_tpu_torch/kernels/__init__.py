"""Transform engines: the Hopper kernel wrappers and the plain torch engines."""
