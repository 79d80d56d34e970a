// C-ABI wrapper around the reference's DBG polish chain
// (src/correctionDBG.cpp polishCorrection + src/DBG.cpp link/
// extendLeft/extendRight), compiled in place from /root/reference/src
// with tests/ref_shim/bmean_utils_stub.h standing in for the missing
// BMEAN submodule's utils.h.  Used by tests/test_reference_diff.py to
// fuzz-diff consent_jax.core.dbg.polish_correction (and the native
// fast path) byte-for-byte against the compiled reference.
#include <cstdint>
#include <cstring>
#include <string>

#include "correctionDBG.h"
#include "robin_hood.h"

extern "C" {

// read: mixed-case ACGT/acgt string (case = solidity channel).
// keys/cnts: the window's k-mer counts (keys in the A=0 C=1 G=2 T=3
// 2-bit encoding shared with consent_jax's dense tables).
// Returns the polished string's length, or -1 if out_cap is too small.
int64_t ref_polish_correction(const char* read, int64_t read_len,
                              const uint64_t* keys, const uint32_t* cnts,
                              int64_t n_keys, uint32_t mer_size,
                              int32_t solid_thresh, char* out,
                              int64_t out_cap) {
    robin_hood::unordered_map<kmer, unsigned> merCounts;
    for (int64_t i = 0; i < n_keys; i++) {
        merCounts[(kmer)keys[i]] = cnts[i];
    }
    std::string r = polishCorrection(std::string(read, read_len),
                                     merCounts, mer_size, solid_thresh);
    if ((int64_t)r.size() > out_cap) return -1;
    memcpy(out, r.data(), r.size());
    return (int64_t)r.size();
}

}  // extern "C"
