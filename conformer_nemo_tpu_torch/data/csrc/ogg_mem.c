/* In-memory Ogg/Vorbis decode over the system libvorbisfile.
 *
 * The reference's AudioSegment decodes ogg via libsndfile. Hosts often
 * ship the runtime codec libraries without their headers, so the needed
 * prototypes are declared here (stable libvorbis 1.x ABI) and the shim is
 * linked against the versioned .so by full path at build time
 * (conformer_nemo_tpu_torch/ops/build.py builds it at first use).
 *
 * ctypes cannot drive ov_open_callbacks directly (the by-value ov_callbacks
 * struct mis-crosses the libffi boundary for this entry point — verified
 * against a C caller that works), hence this C-side memory cursor.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t ogg_int64_t;

typedef struct {
  size_t (*read_func)(void *ptr, size_t size, size_t nmemb, void *datasource);
  int (*seek_func)(void *datasource, ogg_int64_t offset, int whence);
  int (*close_func)(void *datasource);
  long (*tell_func)(void *datasource);
} ov_callbacks;

typedef struct {
  int version;
  int channels;
  long rate;
  /* bitrate fields + codec_setup follow; unused here */
} vorbis_info_head;

extern int ov_open_callbacks(void *datasource, void *vf, const char *initial,
                             long ibytes, ov_callbacks callbacks);
extern void *ov_info(void *vf, int link);
extern long ov_read(void *vf, char *buffer, int length, int bigendianp,
                    int word, int sgned, int *bitstream);
extern int ov_clear(void *vf);

typedef struct {
  const unsigned char *data;
  size_t len, pos;
} mem_cursor;

static size_t mem_read(void *ptr, size_t size, size_t nmemb, void *src) {
  mem_cursor *m = (mem_cursor *)src;
  size_t want = size * nmemb, avail = m->len - m->pos;
  if (want > avail) want = avail;
  memcpy(ptr, m->data + m->pos, want);
  m->pos += want;
  return size ? want / size : 0;
}

static int mem_seek(void *src, ogg_int64_t offset, int whence) {
  mem_cursor *m = (mem_cursor *)src;
  ogg_int64_t base = whence == 0 ? 0 : whence == 1 ? (ogg_int64_t)m->pos
                                                   : (ogg_int64_t)m->len;
  ogg_int64_t target = base + offset;
  if (target < 0 || target > (ogg_int64_t)m->len) return -1;
  m->pos = (size_t)target;
  return 0;
}

static long mem_tell(void *src) { return (long)((mem_cursor *)src)->pos; }

/* Decode a whole in-memory Ogg/Vorbis stream to interleaved s16.
 * Returns 0 on success; out buffer must be released with ogg_vorbis_free. */
int ogg_vorbis_decode(const unsigned char *data, int64_t len, int16_t **out,
                      int64_t *n_frames, int *channels, int *rate) {
  mem_cursor m = {data, (size_t)len, 0};
  ov_callbacks cb = {mem_read, mem_seek, NULL, mem_tell};
  char vf[4096]; /* OggVorbis_File is ~944 B; opaque oversized storage */
  int rc = ov_open_callbacks(&m, vf, NULL, 0, cb);
  if (rc != 0) return rc;
  vorbis_info_head *vi = (vorbis_info_head *)ov_info(vf, -1);
  if (!vi || vi->channels <= 0) {
    ov_clear(vf);
    return -1;
  }
  *channels = vi->channels;
  *rate = (int)vi->rate;
  size_t cap = 1 << 16, used = 0; /* bytes */
  char *buf = (char *)malloc(cap);
  if (!buf) {
    ov_clear(vf);
    return -2;
  }
  int bitstream = 0;
  for (;;) {
    if (cap - used < (size_t)(1 << 15)) {
      cap *= 2;
      char *nb = (char *)realloc(buf, cap);
      if (!nb) {
        free(buf);
        ov_clear(vf);
        return -2;
      }
      buf = nb;
    }
    long n = ov_read(vf, buf + used, (int)(cap - used), 0, 2, 1, &bitstream);
    if (n == 0) break;
    if (n == -3 /* OV_HOLE */) continue; /* recoverable sync gap */
    if (n < 0) { /* OV_EBADLINK etc: corrupt stream — fail, don't spin */
      free(buf);
      ov_clear(vf);
      return (int)n;
    }
    used += (size_t)n;
  }
  ov_clear(vf);
  *out = (int16_t *)buf;
  *n_frames = (int64_t)(used / 2 / (size_t)*channels);
  return 0;
}

void ogg_vorbis_free(int16_t *p) { free(p); }
