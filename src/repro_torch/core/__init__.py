"""CBList storage, updates, engine and vertex-program executor."""
