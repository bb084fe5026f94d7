"""The serving tier of the port: page pool, queue, engine, postprocess."""
