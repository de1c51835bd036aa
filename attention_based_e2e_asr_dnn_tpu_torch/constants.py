"""Output-symbol vocabulary constants (the port's own copy of the JAX
package's ``constants.py``; nothing of that package is imported).

30 symbols: ``<sos>``, A-Z, apostrophe, space, ``<eos>``; ``<eos>`` (index 29)
doubles as the padding index.
"""

VOCAB = [
    "<sos>",
    "A", "B", "C", "D",
    "E", "F", "G", "H",
    "I", "J", "K", "L",
    "M", "N", "O", "P",
    "Q", "R", "S", "T",
    "U", "V", "W", "X",
    "Y", "Z", "'", " ",
    "<eos>",
]

VOCAB_MAP = {symbol: index for index, symbol in enumerate(VOCAB)}

SOS_IDX = VOCAB_MAP["<sos>"]
EOS_IDX = VOCAB_MAP["<eos>"]

# <eos> doubles as padding, matching the reference's collate padding value of 29
# (reference: src/utils.py:96) and embedding padding_idx (src/models.py:264).
PAD_IDX = EOS_IDX

VOCAB_SIZE = len(VOCAB)
