"""Signal ops: the mu-law codec and the AR-generation kernel wrapper."""
