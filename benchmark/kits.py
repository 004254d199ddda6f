"""ONT kit sequences (EXP-NBD103, SQK-RBK004) for the benchmark's corpus.

A frozen copy of ``deepbinner_tpu_torch/utils/kits.py`` at commit
402717dbde1c47220f6674dc523b70c64264754a: the sequences and the read
layout the shipped models were trained on.  Kept here so that the corpus
does not change when the port's copy does.
"""

from __future__ import annotations

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
NUM_BARCODES = 12

BARCODES = {
    1: "AAGAAAGTTGTCGGTGTCTTTGTG",
    2: "TCGATTCCGTTTGTAGTCGTCTGT",
    3: "GAGTCTTGTGTCCCAGTTACCAGG",
    4: "TTCGGATTCTATCGTGTTTCCCTA",
    5: "CTTGTCCAGGGTTTGTGTAACCTT",
    6: "TTCTCGCAAAGGCAGAAAGTAGTC",
    7: "GTGTTACCGTGGGAATGAATCCTT",
    8: "TTCAGGGAACAAACCAAGTTACGT",
    9: "AACTAGGCACAGCGAGTCTTGGTT",
    10: "AAGCGTTGAAACCTTTGTCCTCTC",
    11: "GTTTCATCTATCGGAGGGAATGGA",
    12: "CAGGTAGAAAGAAGCAGAATCGGA",
}
NATIVE_START_FLANK_LEFT = "AAGGTTAA"
NATIVE_START_FLANK_RIGHT = "CAGCACCT"
NATIVE_END_FLANK_LEFT = "AGGTGCTG"
NATIVE_END_FLANK_RIGHT = "TTAACCTT"
LIGATION_ADAPTER_TOP = "AATGTACTTCGTTCAGTTACGTATTGCT"
RAPID_ADAPTER = "GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA"
KITS = ("EXP-NBD103", "SQK-RBK004")


def reverse_complement(seq: str) -> str:
    return "".join(COMPLEMENT[b] for b in reversed(seq))


def _check_kit(kit: str) -> None:
    if kit not in KITS:
        raise ValueError(f"unknown kit {kit!r}; choose from {KITS}")


def start_region(kit: str, barcode: int) -> str:
    """What a read carries before its genomic part (``barcode`` 0: none)."""
    _check_kit(kit)
    parts = [LIGATION_ADAPTER_TOP]
    if barcode > 0:
        if kit == "EXP-NBD103":
            parts.append(NATIVE_START_FLANK_LEFT
                         + reverse_complement(BARCODES[barcode])
                         + NATIVE_START_FLANK_RIGHT)
        else:
            parts.append(BARCODES[barcode] + RAPID_ADAPTER)
    return "".join(parts)


def end_region(kit: str, barcode: int) -> str:
    """What a read carries after its genomic part: the native kit's end
    barcode and the adapter's reverse complement; nothing otherwise."""
    _check_kit(kit)
    if kit != "EXP-NBD103" or barcode == 0:
        return ""
    return (NATIVE_END_FLANK_LEFT + BARCODES[barcode] + NATIVE_END_FLANK_RIGHT
            + reverse_complement(LIGATION_ADAPTER_TOP))

