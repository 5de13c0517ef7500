"""Reader helpers of the port (paddle_tpu/reader). Only the producer and
consumer cancellation handshake that the feeder uses is here; the reader
decorators (map_readers, buffered, shuffle, ...) come with a later part
of the port."""
