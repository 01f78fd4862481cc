"""The serving engine of the port: paged pool, chunked scheduler."""
