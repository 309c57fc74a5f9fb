// Native exact-arithmetic core for gpuntt_tpu (host side).
//
// TPU-native equivalent of the reference's host/CPU C++ layer:
//  - table generation (nttparameters.cu:144-168, :356-444) — sequential
//    modular power tables and W twiddle matrices, exact via __int128;
//  - the CPU golden transforms (ntt_cpu.cu:81-185, ntt_4step_cpu.cu's
//    core_ntt/core_intt) used as the bit-exactness oracle;
//  - Shoup companion tables floor(w << 64 / q) for the TPU engines.
//
// Python-int arithmetic is exact but ~100x slower at 2^20+ table sizes;
// this library keeps parameter construction and golden checks fast.
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
//
// Modulus bound: q < 2^63 (Shoup constant-multiply validity) — covers
// the reference's documented 62-bit Barrett range with a bit to spare.

#include <cstdint>
#include <cstddef>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

static inline u64 mulmod(u64 a, u64 b, u64 q) {
    return (u64)(((u128)a * b) % q);
}

static inline u64 powmod(u64 base, u64 exp, u64 q) {
    u64 r = 1 % q;
    base %= q;
    while (exp) {
        if (exp & 1) r = mulmod(r, base, q);
        base = mulmod(base, base, q);
        exp >>= 1;
    }
    return r;
}

static inline int bitrev(int x, int bits) {
    int r = 0;
    for (int i = 0; i < bits; i++) { r = (r << 1) | (x & 1); x >>= 1; }
    return r;
}

// Shoup constant-multiply: one u128 division precomputes the companion,
// then each product is two multiplies + a conditional subtract.  Exact
// canonical residue for w < q < 2^63, any x (r = xw - floor(x wsh/2^64) q
// < 2q < 2^64).  ~15x faster than the __umodti3 software division that
// `mulmod` emits — this is what keeps 2^24-28 table generation and
// golden transforms at minutes-not-hours test cost.
static inline u64 shoup(u64 w, u64 q) {
    return (u64)((((u128)w) << 64) / q);
}

static inline u64 mulmod_shoup(u64 x, u64 w, u64 wsh, u64 q) {
    u64 hi = (u64)(((u128)x * wsh) >> 64);
    u64 r = x * w - hi * q;
    if (r >= q) r -= q;
    return r;
}

extern "C" {

// out[i] = base^i mod q, i in [0, n)
void power_table_u64(u64 base, u64 q, u64* out, size_t n) {
    base %= q;
    u64 bsh = shoup(base, q);
    u64 acc = 1 % q;
    for (size_t i = 0; i < n; i++) {
        out[i] = acc;
        acc = mulmod_shoup(acc, base, bsh, q);
    }
}

// out[i] = floor(w[i] * 2^64 / q)  (Shoup companion)
void shoup_table_u64(const u64* w, u64 q, u64* out, size_t n) {
    for (size_t i = 0; i < n; i++) {
        out[i] = (u64)((((u128)w[i]) << 64) / q);
    }
}

// out[i] = table[bitreverse(i, lg)]
void bitrev_permute_u64(const u64* table, u64* out, int lg) {
    size_t n = (size_t)1 << lg;
    for (size_t i = 0; i < n; i++) out[i] = table[bitrev((int)i, lg)];
}

// Forward W table: out[i*n2+j] = root^(bitrev(i, log n1) * j)
// (nttparameters.cu:382-396, built as per-row geometric series).
void w_table_forward_u64(u64 root, u64 q, int n1, int n2, u64* out) {
    int lg = 0; while ((1 << lg) < n1) lg++;
    for (int i = 0; i < n1; i++) {
        u64 base = powmod(root, (u64)bitrev(i, lg), q);
        u64 bsh = shoup(base, q);
        u64 acc = 1 % q;
        for (int j = 0; j < n2; j++) {
            out[(size_t)i * n2 + j] = acc;
            acc = mulmod_shoup(acc, base, bsh, q);
        }
    }
}

// Inverse W table: out[i*n2+j] = invroot^(bitrev(j, log n2) * i)
// (nttparameters.cu:430-444).
void w_table_inverse_u64(u64 invroot, u64 q, int n1, int n2, u64* out) {
    int lg = 0; while ((1 << lg) < n2) lg++;
    for (int i = 0; i < n1; i++) {
        u64 base = powmod(invroot, (u64)i, q);
        u64 bsh = shoup(base, q);
        // row = powers of base, stored at bit-reversed positions
        u64 acc = 1 % q;
        for (int j = 0; j < n2; j++) {
            out[(size_t)i * n2 + bitrev(j, lg)] = acc;
            acc = mulmod_shoup(acc, base, bsh, q);
        }
    }
}

// Shoup companions of the twiddle table (heap buffer, caller frees).
// Table span: the transforms index up to n-1 (xnp) / n/2-1 (cyclic).
static u64* table_companions(const u64* table, u64 q, size_t count) {
    u64* tsh = new u64[count];
    for (size_t i = 0; i < count; i++) tsh[i] = shoup(table[i], q);
    return tsh;
}

static void ntt_merge_impl(u64* data, int logn, const u64* table,
                           const u64* tsh, u64 q, int xnp) {
    size_t n = (size_t)1 << logn;
    size_t t = n;
    for (size_t m = 1; m < n; m <<= 1) {
        t >>= 1;
        for (size_t i = 0; i < m; i++) {
            size_t j1 = 2 * i * t;
            int index = xnp ? bitrev((int)(m + i), logn)
                            : bitrev((int)i, logn - 1);
            u64 s = table[index];
            u64 ssh = tsh[index];
            for (size_t j = j1; j < j1 + t; j++) {
                u64 u = data[j];
                u64 v = mulmod_shoup(data[j + t], s, ssh, q);
                u64 add = u + v; if (add >= q) add -= q;
                u64 sub = u + q - v; if (sub >= q) sub -= q;
                data[j] = add;
                data[j + t] = sub;
            }
        }
    }
}

static void intt_merge_impl(u64* data, int logn, const u64* table,
                            const u64* tsh, u64 q, int xnp) {
    size_t n = (size_t)1 << logn;
    size_t t = 1;
    for (size_t m = n; m > 1; m >>= 1) {
        size_t h = m >> 1;
        size_t j1 = 0;
        for (size_t i = 0; i < h; i++) {
            int index = xnp ? bitrev((int)(h + i), logn)
                            : bitrev((int)i, logn - 1);
            u64 s = table[index];
            u64 ssh = tsh[index];
            for (size_t j = j1; j < j1 + t; j++) {
                u64 u = data[j];
                u64 v = data[j + t];
                u64 add = u + v; if (add >= q) add -= q;
                u64 sub = u + q - v; if (sub >= q) sub -= q;
                data[j] = add;
                data[j + t] = mulmod_shoup(sub, s, ssh, q);
            }
            j1 += (t << 1);
        }
        t <<= 1;
    }
    u64 n_inv = powmod(n % q, q - 2, q);
    u64 nsh = shoup(n_inv, q);
    for (size_t i = 0; i < n; i++)
        data[i] = mulmod_shoup(data[i], n_inv, nsh, q);
}

static size_t table_span(int logn, int xnp) {
    size_t n = (size_t)1 << logn;
    size_t span = xnp ? n : (n >> 1);
    return span ? span : 1;
}

// In-place merged forward NTT (golden; ntt_cpu.cu:81-128 semantics).
// table: NATURAL-order root powers; xnp selects the X_N_plus indexing.
void ntt_merge_u64(u64* data, int logn, const u64* table, u64 q, int xnp) {
    u64* tsh = table_companions(table, q, table_span(logn, xnp));
    ntt_merge_impl(data, logn, table, tsh, q, xnp);
    delete[] tsh;
}

// In-place merged inverse NTT + n^-1 (golden; ntt_cpu.cu:130-185).
void intt_merge_u64(u64* data, int logn, const u64* table, u64 q, int xnp) {
    u64* tsh = table_companions(table, q, table_span(logn, xnp));
    intt_merge_impl(data, logn, table, tsh, q, xnp);
    delete[] tsh;
}

// Batched wrappers (batch-major contiguous rows); companions shared.
void ntt_merge_batch_u64(u64* data, int batch, int logn, const u64* table,
                         u64 q, int xnp) {
    size_t n = (size_t)1 << logn;
    u64* tsh = table_companions(table, q, table_span(logn, xnp));
    for (int b = 0; b < batch; b++)
        ntt_merge_impl(data + (size_t)b * n, logn, table, tsh, q, xnp);
    delete[] tsh;
}

void intt_merge_batch_u64(u64* data, int batch, int logn, const u64* table,
                          u64 q, int xnp) {
    size_t n = (size_t)1 << logn;
    u64* tsh = table_companions(table, q, table_span(logn, xnp));
    for (int b = 0; b < batch; b++)
        intt_merge_impl(data + (size_t)b * n, logn, table, tsh, q, xnp);
    delete[] tsh;
}

// core_ntt / core_intt over rows (golden 4-step building blocks,
// ntt_4step_cpu.cu:117-196; X_N_minus-style indexing always).
void core_ntt_rows_u64(u64* data, int rows, int log_size, const u64* table, u64 q) {
    size_t n = (size_t)1 << log_size;
    u64* tsh = table_companions(table, q, table_span(log_size, 0));
    for (int r = 0; r < rows; r++)
        ntt_merge_impl(data + (size_t)r * n, log_size, table, tsh, q, 0);
    delete[] tsh;
}

void core_intt_rows_u64(u64* data, int rows, int log_size, const u64* table, u64 q) {
    // like intt_merge_u64 but WITHOUT the n^-1 scaling
    size_t n = (size_t)1 << log_size;
    u64* tsh = table_companions(table, q, table_span(log_size, 0));
    for (int r = 0; r < rows; r++) {
        u64* d = data + (size_t)r * n;
        size_t t = 1;
        for (size_t m = n; m > 1; m >>= 1) {
            size_t h = m >> 1;
            size_t j1 = 0;
            for (size_t i = 0; i < h; i++) {
                int index = bitrev((int)i, log_size - 1);
                u64 s = table[index];
                u64 ssh = tsh[index];
                for (size_t j = j1; j < j1 + t; j++) {
                    u64 u = d[j];
                    u64 v = d[j + t];
                    u64 add = u + v; if (add >= q) add -= q;
                    u64 sub = u + q - v; if (sub >= q) sub -= q;
                    d[j] = add;
                    d[j + t] = mulmod_shoup(sub, s, ssh, q);
                }
                j1 += (t << 1);
            }
            t <<= 1;
        }
    }
    delete[] tsh;
}

// Pointwise c[i] = a[i] * b[i] mod q
void pointwise_mult_u64(const u64* a, const u64* b, u64* c, size_t n, u64 q) {
    for (size_t i = 0; i < n; i++) c[i] = mulmod(a[i], b[i], q);
}

u64 powmod_u64(u64 base, u64 exp, u64 q) { return powmod(base, exp, q); }
u64 modinv_u64(u64 a, u64 q) { return powmod(a, q - 2, q); }

} // extern "C"
