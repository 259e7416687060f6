// In-memory vector store: contiguous f32 keys, exact-key index, cosine
// top-K (C ABI).
//
// Native counterpart of the reference's Go local-store worker
// (backend/go/stores/store.go:39-511 — StoresSet upsert :106, StoresGet
// :266, StoresFindNormalized :373 normalized fast path, top-K heap :349).
// Values stay on the Python side keyed by row id; this library owns the
// numeric hot path: key storage, dedup, deletion compaction, and the
// similarity scan.
//
// Built at first use by localai_tfp_tpu_torch/utils/cxx.py (g++ -O3
// -std=c++17 -fPIC -shared) into build/torch_kernels/libvecstore-<hash>.so;
// bound by localai_tfp_tpu_torch/store/native.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct Store {
    int dim = 0;
    std::vector<float> keys;      // n * dim
    std::vector<float> norms;     // n
    std::unordered_map<std::string, int64_t> index;  // key bytes -> row
    bool normalized = true;

    int64_t rows() const { return dim ? (int64_t)norms.size() : 0; }

    std::string kb(const float *k) const {
        return std::string((const char *)k, dim * sizeof(float));
    }
};

}  // namespace

extern "C" {

void *vs_new(void) { return new Store(); }
void vs_free(void *h) { delete (Store *)h; }

int64_t vs_len(void *h) { return ((Store *)h)->rows(); }
int vs_dim(void *h) { return ((Store *)h)->dim; }
int vs_normalized(void *h) { return ((Store *)h)->normalized ? 1 : 0; }

// upsert n rows; out_rowids[n] receives each key's row id (existing row
// for duplicates — the caller stores values by row id). returns -1 on
// dim mismatch.
int64_t vs_set(void *h, const float *keys, int64_t n, int dim,
               int64_t *out_rowids) {
    auto *s = (Store *)h;
    if (s->dim == 0) s->dim = dim;
    if (dim != s->dim) return -1;
    for (int64_t i = 0; i < n; i++) {
        const float *k = keys + i * dim;
        auto key = s->kb(k);
        auto it = s->index.find(key);
        if (it != s->index.end()) {
            out_rowids[i] = it->second;
            continue;
        }
        int64_t row = s->rows();
        s->keys.insert(s->keys.end(), k, k + dim);
        double acc = 0;
        for (int d = 0; d < dim; d++) acc += (double)k[d] * k[d];
        float norm = (float)std::sqrt(acc);
        s->norms.push_back(norm);
        if (std::fabs(norm - 1.0f) > 1e-4f) s->normalized = false;
        s->index[std::move(key)] = row;
        out_rowids[i] = row;
    }
    return s->rows();
}

// exact-key lookups: out_rowids[i] = row or -1
void vs_get(void *h, const float *keys, int64_t n, int64_t *out_rowids) {
    auto *s = (Store *)h;
    for (int64_t i = 0; i < n; i++) {
        auto it = s->index.find(s->kb(keys + i * s->dim));
        out_rowids[i] = it == s->index.end() ? -1 : it->second;
    }
}

// delete rows by key; compacts storage. out_remap[old_row] = new_row or
// -1 for deleted (remap has vs_len entries BEFORE the call). returns
// number deleted.
int64_t vs_delete(void *h, const float *keys, int64_t n,
                  int64_t *out_remap) {
    auto *s = (Store *)h;
    int64_t old_n = s->rows();
    std::vector<char> drop(old_n, 0);
    int64_t dropped = 0;
    for (int64_t i = 0; i < n; i++) {
        auto it = s->index.find(s->kb(keys + i * s->dim));
        if (it != s->index.end() && !drop[it->second]) {
            drop[it->second] = 1;
            dropped++;
        }
    }
    if (!dropped) {
        for (int64_t r = 0; r < old_n; r++) out_remap[r] = r;
        return 0;
    }
    int64_t w = 0;
    for (int64_t r = 0; r < old_n; r++) {
        if (drop[r]) { out_remap[r] = -1; continue; }
        if (w != r) {
            memmove(s->keys.data() + w * s->dim,
                    s->keys.data() + r * s->dim, s->dim * sizeof(float));
            s->norms[w] = s->norms[r];
        }
        out_remap[r] = w++;
    }
    s->keys.resize(w * s->dim);
    s->norms.resize(w);
    s->index.clear();
    for (int64_t r = 0; r < w; r++)
        s->index[s->kb(s->keys.data() + r * s->dim)] = r;
    return dropped;
}

// cosine top-K: fills out_rows/out_sims (desc). returns count (<= topk).
int64_t vs_find(void *h, const float *query, int64_t topk,
                int64_t *out_rows, float *out_sims) {
    auto *s = (Store *)h;
    int64_t n = s->rows();
    if (!n) return 0;
    int dim = s->dim;
    double qacc = 0;
    for (int d = 0; d < dim; d++) qacc += (double)query[d] * query[d];
    float qn = (float)std::sqrt(qacc);

    std::vector<float> sims(n);
    const float *K = s->keys.data();
    for (int64_t r = 0; r < n; r++) {
        const float *k = K + r * dim;
        float dot = 0;
        for (int d = 0; d < dim; d++) dot += k[d] * query[d];
        sims[r] = s->normalized
            ? dot
            : dot / std::max(s->norms[r] * qn, 1e-12f);
    }
    int64_t k = std::min(topk, n);
    std::vector<int64_t> idx(n);
    for (int64_t r = 0; r < n; r++) idx[r] = r;
    std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                      [&](int64_t a, int64_t b) { return sims[a] > sims[b]; });
    for (int64_t r = 0; r < k; r++) {
        out_rows[r] = idx[r];
        out_sims[r] = sims[idx[r]];
    }
    return k;
}

// copy a row's key out (for find results)
void vs_row_key(void *h, int64_t row, float *out) {
    auto *s = (Store *)h;
    memcpy(out, s->keys.data() + row * s->dim, s->dim * sizeof(float));
}

}  // extern "C"
