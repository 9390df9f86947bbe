"""Galaxy image search and the catalog I/O around it."""
