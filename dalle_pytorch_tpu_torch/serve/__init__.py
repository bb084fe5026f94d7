"""The serving tier of the port: page pool, prefix cache, queue, engine,
postprocess."""
