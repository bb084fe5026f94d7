"""The serving tier of the port: page pool, prefix cache, queue, engine,
postprocess, the replica set and its autoscaler, the HTTP server."""
