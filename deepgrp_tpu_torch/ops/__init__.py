"""Host and device operators: code encoding, overlap-max merge, MSS
labelling and segment iteration."""
