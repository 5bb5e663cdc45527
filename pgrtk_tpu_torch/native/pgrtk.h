/* C ABI of the port's host C++ copies of the JAX package's native
 * runtime (pgrtk_tpu/native/src/pgrtk.h): the parts that the O(nD) diff
 * alignment (match.cc) and the sparse anchor-chain DP (chain.cc) use,
 * and the PGA and AGC v2 archive readers' (pga.cc, agc.cc).
 *
 *   - O(nD) greedy diff alignment ("match_reads", reference
 *     pgr-db/src/shmmrutils.rs:57-223)
 *   - sparse anchor-chaining DP ("sparse_aln", pgr-db/src/aln.rs:12-142)
 *
 * Every buffer an entry point returns is malloc'd and freed with
 * pgr_free (dfs_walk.cc).
 */
#ifndef PGRTK_TORCH_H
#define PGRTK_TORCH_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

void pgr_free(void *p);

/* ---- O(nD) diff alignment ---- */
typedef struct {
  uint32_t x, y;
  int32_t dk;
} pgr_delta;

typedef struct {
  uint32_t m_size, dist, bgn0, end0, bgn1, end1, m_end0, m_end1;
  pgr_delta *deltas; /* malloc'd, n_deltas entries (NULL if !get_delta) */
  int64_t n_deltas;
  int32_t matched; /* 0 => no match (other fields undefined) */
} pgr_ovlp;

void pgr_match_reads(const uint8_t *seq0, int64_t len0, const uint8_t *seq1,
                     int64_t len1, int get_delta, double tol,
                     uint32_t min_match_len, uint32_t min_match_start,
                     uint32_t bandwidth, pgr_ovlp *out);

/* pgr_match_reads of n pairs (seq0[i], seq1[i]) into out[i], on
 * n_threads threads that each take the next pair. */
void pgr_match_reads_batch(int64_t n, const uint8_t *const *seq0,
                           const int64_t *len0, const uint8_t *const *seq1,
                           const int64_t *len1, int get_delta, double tol,
                           uint32_t min_match_len, uint32_t min_match_start,
                           uint32_t bandwidth, int32_t n_threads,
                           pgr_ovlp *out);

/* ---- sparse anchor chain DP ----
 * hits: n x 6 uint32 (q_bgn, q_end, q_ori, t_bgn, t_end, t_ori), n >= 1.
 * Output blob layout (malloc'd into *out, length written to *out_len,
 * all 4-byte words):
 *   [n_chains]
 *   per chain: [score_f32][n_hits][n_hits * 6 x u32 hitpair]
 * Returns n_chains, or -1 when a traceback revisits an anchor (an exact
 * duplicate that recurs after other anchors makes the value-keyed
 * predecessors cycle): *out is then NULL and cycle[0..11] holds the
 * anchor the walk started from and the anchor it revisited. */
int64_t pgr_sparse_aln(const uint32_t *hits, int64_t n, uint32_t max_span,
                       float penalty, int64_t max_gap /* <0 => none */,
                       int oriented, uint32_t **out, int64_t *out_len,
                       uint32_t *cycle);

/* ---- PGA archive (pga.cc, a library of its own) ----
 * Readers: pga_open returns a handle (NULL when the file is not a well-
 * formed archive); list and fetch results are malloc'd, freed with
 * pga_free; pga_get_sub_seq returns the bases written or -1.  Writer:
 * pga_create, pga_add_contig per contig, pga_finish (0 on success). */
void *pga_open(const char *path);
void pga_close(void *h);
void pga_free(void *p);
int64_t pga_n_samples(void *h);
char *pga_list_samples(void *h);
char *pga_list_ctgs(void *h, const char *sample);
int64_t pga_get_ctg_len(void *h, const char *sample, const char *ctg);
int64_t pga_get_sub_seq(void *h, const char *sample, const char *ctg,
                        int64_t bgn, int64_t end, uint8_t **out);
void *pga_create(const char *path, int level);
int pga_add_contig(void *h, const char *sample, const char *ctg,
                   const uint8_t *seq, int64_t len);
int pga_finish(void *h);

/* ---- AGC v2 archive reader (agc.cc, in the PGA archive's library) ----
 * agc_open returns a handle (NULL when the file is not a well-formed
 * archive); list and fetch results are malloc'd, freed with pga_free;
 * agc_get_ctg_len returns -1 and agc_get_sub_seq -1 on an unknown contig
 * (an empty sample name searches every sample), end < 0 meaning the
 * contig's end.  A handle may be shared by threads. */
void *agc_open(const char *path);
void agc_close(void *h);
char *agc_list_samples(void *h);
char *agc_list_ctgs(void *h, const char *sample);
int64_t agc_get_ctg_len(void *h, const char *sample, const char *ctg);
int64_t agc_get_sub_seq(void *h, const char *sample, const char *ctg,
                        int64_t bgn, int64_t end, uint8_t **out);

/* libzstd's one-shot API (zstd.h; stable since zstd 1.0) and the frame
 * size of a buffer that holds more than one frame (stable since zstd
 * 1.3.0), which pga.cc and agc.cc call through the runtime
 * libzstd.so.1. */
size_t ZSTD_compress(void *dst, size_t dstCapacity, const void *src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void *dst, size_t dstCapacity, const void *src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_findFrameCompressedSize(const void *src, size_t srcSize);

#ifdef __cplusplus
}
#endif
#endif /* PGRTK_TORCH_H */
