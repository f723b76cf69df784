"""Host runtime of the port: the native JPEG loader's binding."""
