"""Peer identity (a trimmed copy of ``spacedrive_tpu/p2p``): the ed25519
instance identities a library's ``instance`` rows carry. Discovery,
pairing, the handshakes and the sync sessions over the network are not
ported."""
