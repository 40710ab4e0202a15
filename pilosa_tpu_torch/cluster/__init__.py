"""The cluster layer of the port (counterpart of ``pilosa_tpu/cluster``):
placement, the wire, the internal client, broadcasts, key translation
through the primary, and the distributed executor with its mesh route,
on which nodes of one process answer each other's shards with one launch
on the card over a read-only holder facade."""
